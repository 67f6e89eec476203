"""On-device loops: ``while_loop``, the counterpart of ``jax.lax.while_loop``,
and ``device_call``, the counterpart of one call of a jitted JAX function
whose loops stay on the device.

``while_loop(cond, body, carry)`` has JAX's contract: ``carry`` is a pytree
(tuple, list or dict) of tensors of fixed shapes and dtypes, ``body(carry)``
returns a carry of the same structure, ``cond(carry)`` a one-element bool or
int32 tensor on the carry's device, and the result is the last carry.
Counters are int32 tensors on the device, as in JAX.

- On the CPU ``while_loop`` is the plain loop
  ``while bool(cond(c)): c = body(c)`` and ``device_call(fn, carry, key)``
  is ``fn(carry)``.
- On CUDA ``device_call`` runs fn as one CUDA graph, captured at the first
  call of its key and cached: each call copies the carry into the graph's
  input buffers, launches the graph once and returns copies of its
  outputs.  fn may read the carry, what it makes itself, and constants that
  live as long as the process (the DST matrices, the ticket words of
  ``kernels``); Python numbers it bakes in belong in the key.  The key also
  holds the carry's structure, shapes, dtypes and device, and which route
  each kernel wrapper takes (a ``_*_cuda`` attribute swapped for its plain
  version is another key), so a cached graph never replays another route.
- A ``while_loop`` inside fn becomes a conditional WHILE node of the graph
  (``csrc/graph_loop.cu``): cond, then ``WHILE (pred) { body; copy the new
  carry into the loop's buffers; pred = cond }``, the predicate copied into
  the node's handle by a one-thread kernel, no host read.  The loop's
  buffers are copies of the carry; with ``donate=True`` they are the
  carry's tensors themselves (a view, or a second tensor on one storage,
  is copied), which the loop overwrites, so fn must not read them again,
  in the loop or after it, for their old values.  ``unroll=2`` captures
  the body twice per pass, the second pass under an IF node: a body that
  writes its result into the buffer it does not read (a ping-pong pair)
  then ends each double pass on its own carry with no copy, and a single
  copy after the loop puts an odd last pass in place.
- A ``while_loop`` on CUDA outside any ``device_call`` is a graph of its
  own, captured, launched and freed in the call.
- Nothing falls back to the host loop on CUDA: a capture, build or launch
  that fails raises.  ``host_loops()`` runs the plain loops on CUDA as well,
  as the reference that tests and ``chip_smoke.py`` compare the graphs
  with; no entry point takes it.

How a graph is made: fn runs once eagerly with every loop cut to one pass
(which builds whatever its wrappers make at their first call), then on a
side stream under ``torch.cuda.CUDAGraph(keep_graph=True)`` captures that
share one memory pool, a capture per segment between loops, the loops'
bodies inner first; ``csrc/graph_loop.cu`` puts the segments together as
child graphs around the conditional nodes.  The captures run in the order
the graph runs their segments, so a block the allocator hands out again is
free by then.

``kernels.launches`` counts device launches: a wrapper called during a
capture launches nothing, so its count is taken back and added again per
run of the graph, times the passes of the loop it sits in, which the
set-condition kernel counts on the device (``kernels.sync_launches``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time
import warnings
import weakref

import torch

from fpr_tpu_torch import kernels

# cached graphs, least recently used first out
CACHE_SIZE = 8
# graph launches and captures since the process started; the nodes of the
# last graph built (captured nodes, conditional and set nodes) and the
# seconds its warm-up pass, capture and instantiation took
stats = {"launches": 0, "captures": 0, "nodes": 0, "build_s": 0.0}

_IF, _WHILE = 0, 1


class _State(threading.local):
    def __init__(self):
        self.mode = None      # None: graphs on CUDA; "host": plain loops; "warm": one pass
        self.capture = None   # the _Capture being recorded


_state = _State()


@contextlib.contextmanager
def _use(mode=None, capture=None):
    saved = _state.mode, _state.capture
    _state.mode, _state.capture = mode, capture
    try:
        yield
    finally:
        _state.mode, _state.capture = saved


@contextlib.contextmanager
def host_loops():
    """Run every loop as the plain host loop, on CUDA too: the reference
    that the graphs are compared with, bitwise."""
    with _use(mode="host"):
        yield


def _flatten(carry, what):
    """(tensors, structure) of a carry of tensors, tuples, lists, dicts and
    Nones; the structure is hashable."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return "*"
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return type(x), tuple(walk(v) for v in x)
        if isinstance(x, dict):
            return dict, tuple((k, walk(v)) for k, v in x.items())
        raise TypeError(f"{what}: a carry holds tensors only, got {type(x).__name__}")

    return leaves, walk(carry)


def _unflatten(leaves, spec):
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        kind, items = s
        if kind is dict:
            return {k: build(v) for k, v in items}
        return kind(build(v) for v in items)

    return build(spec)


def _signature(leaves, spec):
    return spec, tuple((tuple(t.shape), t.dtype) for t in leaves)


def _check_body(leaves, spec, new):
    """The body's result as leaves, after checking it against the carry."""
    new_leaves, new_spec = _flatten(new, "while_loop body")
    if new_spec != spec or any(a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
                               for a, b in zip(leaves, new_leaves)):
        raise TypeError("while_loop: the body must return a carry of the structure, shapes and "
                        f"dtypes of its input: {_signature(leaves, spec)} became "
                        f"{_signature(new_leaves, new_spec)}")
    return new_leaves


def _pred(p) -> torch.Tensor:
    """cond's result as a 0-dim int32 device tensor (what the set kernel reads)."""
    if not isinstance(p, torch.Tensor) or p.numel() != 1:
        raise TypeError(f"while_loop: cond must return a one-element tensor, got {p!r}")
    if p.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"while_loop: cond must return a bool or int32 tensor, got {p.dtype}")
    return p.reshape(()).to(torch.int32)


def _mode(leaves):
    if _state.capture is not None:
        return "capture"
    if _state.mode is not None:
        return _state.mode
    if not leaves or leaves[0].device.type != "cuda":
        return "host"
    return "graph"


def while_loop(cond, body, carry, *, unroll: int = 1, donate: bool = False):
    """Run body while cond holds (jax.lax.while_loop); see the module
    docstring.  unroll (1 or 2): body passes per graph pass on CUDA;
    donate: the graph's loop may overwrite the carry's tensors.  Neither
    changes a result."""
    if unroll not in (1, 2):
        raise ValueError(f"unroll must be 1 or 2, got {unroll!r}")
    leaves, spec = _flatten(carry, "while_loop")
    mode = _mode(leaves)
    if mode == "capture":
        return _state.capture.loop(cond, body, carry, unroll, donate)
    if mode == "host":
        while bool(cond(carry)):
            new = body(carry)
            _check_body(leaves, spec, new)
            carry = new
        return carry
    if mode == "warm":
        cond(carry)
        return _unflatten(_check_body(leaves, spec, body(carry)), spec)
    return device_call(lambda c: while_loop(cond, body, c, unroll=unroll, donate=donate), carry)


def device_call(fn, carry, key=None):
    """fn(carry), on CUDA as one launch of a CUDA graph cached by key (None:
    captured for this call alone); see the module docstring."""
    leaves, spec = _flatten(carry, "device_call")
    if _mode(leaves) != "graph":
        return fn(carry)
    dev = leaves[0].device
    if any(t.device != dev for t in leaves):
        raise ValueError(f"device_call: the carry spans {sorted({str(t.device) for t in leaves})}")
    if key is None:
        graph = _Graph(fn, leaves, spec, dev)
        try:
            return graph.run(leaves)
        finally:
            graph.close()
    full = (key, _signature(leaves, spec), dev, _route())
    graph = _cache.get(full)
    if graph is None:
        graph = _cache[full] = _Graph(fn, leaves, spec, dev)
        while len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)[1].close()
    else:
        _cache.move_to_end(full)
    return graph.run(leaves)


def _route():
    """Which function each kernel wrapper launches: every ``_*_cuda``
    attribute of the kernel modules."""
    from fpr_tpu_torch.ops import ds, ds3d, dual_time, ns_fused, stencil_pass, vcycle_legs

    return tuple(v for m in (ds, ds3d, dual_time, ns_fused, stencil_pass, vcycle_legs)
                 for k, v in sorted(vars(m).items()) if k.startswith("_") and k.endswith("_cuda"))


_cache: collections.OrderedDict = collections.OrderedDict()
_live: weakref.WeakSet = weakref.WeakSet()


def _fold_all() -> None:
    for graph in list(_live):
        graph.fold()


kernels._device_counts.append(_fold_all)


class _Cond:
    """A conditional node (IF or WHILE) on pred, with its body's items."""

    def __init__(self, kind, pred):
        self.kind, self.pred, self.body = kind, pred, []


class _Set:
    """The set kernel: target's handle from pred, one more pass in counter."""

    def __init__(self, target, pred, counter):
        self.target, self.pred, self.counter = target, pred, counter


def _own(leaves):
    """The loop's buffers: the carry's tensors, except that a view, or a
    tensor whose storage an earlier one uses, is copied."""
    seen, out = set(), []
    for t in leaves:
        p = t.untyped_storage().data_ptr()
        if t._base is not None or p in seen or not t.is_contiguous():
            t = t.clone(memory_format=torch.contiguous_format)
            p = t.untyped_storage().data_ptr()
        seen.add(p)
        out.append(t)
    return out


def _store(bufs, new):
    """Copy a new carry into the loop's buffers (a leaf that is its buffer
    stays; one that shares a buffer's storage is copied aside first)."""
    owned = {b.untyped_storage().data_ptr() for b in bufs}
    new = [n.clone() if n is not b and n.untyped_storage().data_ptr() in owned else n
           for b, n in zip(bufs, new)]
    for b, n in zip(bufs, new):
        if n is not b:
            b.copy_(n)


class _Capture:
    """The segments of one graph, captured in the order they run."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.root = []                # segments (CUDAGraphs), _Conds and _Sets, in order
        self.seqs = [self.root]       # where the next items go
        self.root_counts = dict.fromkeys(kernels.KERNELS, 0)
        self.counts = [self.root_counts]
        self.counted = []             # launches of each loop or IF body (its pass counter)
        self.graph = None
        self.mark = None

    def run(self, fn, carry):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.begin()
            try:
                out = fn(carry)
                self.end()
            except BaseException:
                self.abort()
                raise
        cur.wait_stream(self.stream)
        return out

    def begin(self):
        self.mark = dict(kernels.launches)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.capture_begin(pool=self.pool)

    def end(self):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty.*")
            graph.capture_end()
        counts = self.counts[-1]
        for k, v in self.mark.items():
            counts[k] += kernels.launches[k] - v
            kernels.launches[k] = v
        self.seqs[-1].append(graph)

    def abort(self):
        graph, self.graph = self.graph, None
        if graph is not None:
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 - the capture's own error is the one raised
                pass
        if self.mark is not None:
            kernels.launches.update(self.mark)

    def _open(self, cond):
        """Make cond's body the place of the next items; returns its counter."""
        self.seqs.append(cond.body)
        self.counts.append(dict.fromkeys(kernels.KERNELS, 0))
        self.counted.append(self.counts[-1])
        return len(self.counted) - 1

    def _close(self):
        self.seqs.pop()
        self.counts.pop()

    def loop(self, cond, body, carry, unroll, donate):
        leaves, spec = _flatten(carry, "while_loop")
        bufs = _own(leaves) if donate else [t.clone(memory_format=torch.contiguous_format)
                                            for t in leaves]
        c = _unflatten(bufs, spec)
        pred = _pred(cond(c))
        if unroll == 2:
            odd = torch.zeros((), dtype=torch.int32, device=self.device)
        self.end()
        loop = _Cond(_WHILE, pred)
        self.seqs[-1].append(loop)
        counter = self._open(loop)
        self.begin()
        new = _check_body(bufs, spec, body(c))
        if unroll == 1:
            _store(bufs, new)
            more = _pred(cond(c))
        else:
            first = new
            p1 = _pred(cond(_unflatten(first, spec)))
            odd.copy_(1 - p1)
            more = p1.clone()
            self.end()
            second = _Cond(_IF, p1)
            self.seqs[-1].append(second)
            counter2 = self._open(second)
            self.begin()
            _store(bufs, _check_body(bufs, spec, body(_unflatten(first, spec))))
            more.copy_(_pred(cond(c)))
            self.end()
            second.body.append(_Set(second, p1, counter2))
            self._close()
            self.begin()
        self.end()
        loop.body.append(_Set(loop, more, counter))
        self._close()
        if unroll == 2:  # an odd last pass left the carry in `first`
            fix = _Cond(_IF, odd)
            self.seqs[-1].append(fix)
            counter3 = self._open(fix)
            self.begin()
            _store(bufs, first)
            self.end()
            fix.body.append(_Set(fix, odd, counter3))
            self._close()
        self.begin()
        return c

    def assemble(self, passes):
        """The graph of the captured items and its executable."""
        lib = kernels.lib()
        handles = {}
        self.nodes = 0

        def emit(graph, seq):
            last = None
            for item in seq:
                node = ctypes.c_void_p()
                self.nodes += 1
                if isinstance(item, torch.cuda.CUDAGraph):
                    raw = item.raw_cuda_graph()
                    n = ctypes.c_size_t()
                    kernels.check(lib.fpr_graph_nodes(raw, ctypes.byref(n)), "fpr_graph_nodes")
                    self.nodes += n.value - 1
                    if n.value == 0:
                        continue
                    kernels.check(lib.fpr_graph_add_child(graph, last, raw, ctypes.byref(node)),
                                  "fpr_graph_add_child")
                elif isinstance(item, _Cond):
                    body, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
                    kernels.check(lib.fpr_graph_add_cond(
                        graph, last, item.kind, item.pred.data_ptr(), ctypes.byref(node),
                        ctypes.byref(body), ctypes.byref(handle)), "fpr_graph_add_cond")
                    handles[id(item)] = handle.value
                    emit(body.value, item.body)
                else:
                    kernels.check(lib.fpr_graph_add_set(
                        graph, last, handles[id(item.target)], item.pred.data_ptr(),
                        passes.data_ptr() + 8 * item.counter, ctypes.byref(node)),
                        "fpr_graph_add_set")
                last = node.value
            return last

        graph = ctypes.c_void_p()
        kernels.check(lib.fpr_graph_create(ctypes.byref(graph)), "fpr_graph_create")
        try:
            emit(graph.value, self.root)
            exe = ctypes.c_void_p()
            kernels.check(lib.fpr_graph_instantiate(graph, ctypes.byref(exe)),
                          "fpr_graph_instantiate")
        except BaseException:
            lib.fpr_graph_destroy(graph)
            raise
        return graph.value, exe.value


class _Graph:
    """fn captured as one executable graph with its input buffers."""

    def __init__(self, fn, leaves, spec, device):
        t0 = time.perf_counter()
        self.device, self.graph, self.exe = device, None, None
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in leaves]
        for b, t in zip(self.inputs, leaves):
            b.copy_(t)
        carry = _unflatten(self.inputs, spec)
        with _use(mode="warm"):
            fn(carry)
        torch.cuda.synchronize(device)
        cap = _Capture(device)
        with _use(capture=cap):
            out = cap.run(fn, carry)
        self.out_leaves, self.out_spec = _flatten(out, "device_call result")
        self.cap = cap
        self.passes = torch.zeros(max(len(cap.counted), 1), dtype=torch.int64, device=device)
        self.seen = [0] * len(cap.counted)
        self.graph, self.exe = cap.assemble(self.passes)
        stats["captures"] += 1
        stats["nodes"], stats["build_s"] = cap.nodes, time.perf_counter() - t0
        _live.add(self)

    def run(self, leaves):
        for b, t in zip(self.inputs, leaves):
            if b is not t:
                b.copy_(t)
        lib = kernels.lib()
        kernels.check(lib.fpr_graph_launch(self.exe, torch.cuda.current_stream(self.device)
                                           .cuda_stream), "fpr_graph_launch")
        stats["launches"] += 1
        for k, v in self.cap.root_counts.items():
            kernels.launches[k] += v
        return _unflatten([t.clone() for t in self.out_leaves], self.out_spec)

    def fold(self):
        """Add the launches of the loops' passes since the last fold."""
        if not self.seen or self.exe is None:
            return
        now = self.passes.tolist()
        for i, (n, counts) in enumerate(zip(now, self.cap.counted)):
            d, self.seen[i] = n - self.seen[i], n
            if d:
                for k, v in counts.items():
                    kernels.launches[k] += v * d

    def close(self):
        if self.exe is None:
            return
        self.fold()
        torch.cuda.synchronize(self.device)
        lib = kernels.lib()
        kernels.check(lib.fpr_graph_exec_destroy(self.exe), "fpr_graph_exec_destroy")
        kernels.check(lib.fpr_graph_destroy(self.graph), "fpr_graph_destroy")
        self.exe = self.graph = None
        self.cap = None
        _live.discard(self)
