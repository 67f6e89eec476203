"""The port's utilities (fpr_tpu_torch.utils: io, checkpoint, timing,
profiling, device) against the JAX package's (fpr_tpu.utils).

io: ``load_fortran`` bitwise equal to the JAX loader on every Fortran
fixture, a ``save_fortran`` round trip bitwise, and the CSV functions
writing byte-identical files from the same rows (append, resume by key,
update, the disjoint-header error).  checkpoint: a file written by either
package loads in the other with the same arrays and dtypes, and both refuse
a newer schema.  timing: ``stats_of`` is the JAX ``timed_stats`` summary of
the same samples.  Inputs come from numpy's seeded generator.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch

from fpr_tpu.utils import checkpoint as jckpt
from fpr_tpu.utils import io as jio
from fpr_tpu.utils import timing as jtiming
from fpr_tpu_torch.utils import checkpoint, device, io, profiling, timing

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BINS = sorted(glob.glob(os.path.join(FIXTURES, "*.bin")))


def test_fixtures_exist():
    assert len(BINS) >= 8


@pytest.mark.parametrize("path", BINS, ids=os.path.basename)
def test_load_fortran_matches_jax(path):
    got, want = io.load_fortran(path), jio.load_fortran(path)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_save_fortran_round_trip(tmp_path, rng):
    a = rng.standard_normal((17, 33))
    io.save_fortran(tmp_path / "a.bin", a)
    jio.save_fortran(tmp_path / "b.bin", a)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    back = io.load_fortran(tmp_path / "a.bin")
    assert back.tobytes() == np.ascontiguousarray(a).tobytes()


def test_load_fortran_short_payload(tmp_path):
    p = tmp_path / "short.bin"
    with open(p, "wb") as f:
        np.asarray([4, 3], np.int32).tofile(f)
        np.zeros(5).tofile(f)
    with pytest.raises(ValueError, match="4x3"):
        io.load_fortran(p)


def _rows(rng):
    return [dict(k=k, solver=s, backend="cpu", seconds=float(rng.random()), iters=int(k * 3))
            for k in (4, 5) for s in ("mg", "ds")]


def _both(tmp_path, fn):
    """fn(module, path) with each package's io on a file of its own; the
    two files' bytes and fn's results."""
    pa, pb = tmp_path / "port.csv", tmp_path / "jax.csv"
    ra, rb = fn(io, pa), fn(jio, pb)
    return pa.read_bytes(), pb.read_bytes(), ra, rb


def test_append_csv_row_bytes(tmp_path, rng):
    rows = _rows(rng)

    def fill(mod, path):
        out = [mod.append_csv_row(path, r, key_fields=("k", "solver", "backend")) for r in rows]
        # resume: the same keys again are skipped, a new one appended
        out += [mod.append_csv_row(path, dict(r, seconds=9.0),
                                   key_fields=("k", "solver", "backend")) for r in rows[:2]]
        out.append(mod.append_csv_row(path, dict(rows[0], backend="cuda"),
                                      key_fields=("k", "solver", "backend")))
        # a row with fewer fields goes under the existing header
        out.append(mod.append_csv_row(path, dict(k=6, solver="cg")))
        return out

    a, b, ra, rb = _both(tmp_path, fill)
    assert a == b and ra == rb == [True] * 4 + [False, False, True, True]


def test_csv_has_row_and_update_bytes(tmp_path, rng):
    rows = _rows(rng)

    def fill(mod, path):
        out = [mod.csv_has_rows(path), mod.csv_has_row(path, dict(k=4))]
        for r in rows:
            mod.append_csv_row(path, r)
        out += [mod.csv_has_rows(path), mod.csv_has_row(path, dict(k=5, solver="ds")),
                mod.csv_has_row(path, dict(k=5, solver="cg")),
                mod.update_csv_row(path, dict(k=5, solver="mg"), dict(device_s=0.25, iters=7)),
                mod.update_csv_row(path, dict(k=9), dict(device_s=1.0))]
        return out

    a, b, ra, rb = _both(tmp_path, fill)
    assert a == b and ra == rb == [False, False, True, True, False, True, False]
    assert b"device_s" in a.splitlines()[0]
    assert io.update_csv_row(tmp_path / "absent.csv", dict(k=1), dict(x=1)) is False


def test_disjoint_header_refused(tmp_path):
    for mod, name in ((io, "p.csv"), (jio, "j.csv")):
        mod.append_csv_row(tmp_path / name, dict(a=1, b=2))
        with pytest.raises(ValueError, match=r"row fields \['c'\] not in existing header"):
            mod.append_csv_row(tmp_path / name, dict(a=1, c=3))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _payload(rng):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(T=f32(9, 17), W=f32(9, 17), S_hi=f32(9, 17), S_lo=f32(9, 17) * 1e-8,
                w_sumsq=np.float32(3.5), t_hi=np.float32(0.25), t_lo=np.float32(1e-9),
                step=np.asarray(12))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, rng, writer):
    """Written by one package (the port from tensors), loaded by both."""
    arrays = _payload(rng)
    p = tmp_path / "ck.npz"
    if writer == "port":
        checkpoint.save(p, **{k: torch.as_tensor(v) for k, v in arrays.items()}, t=0.5)
    else:
        jckpt.save(p, **arrays, t=0.5)
    for got in (checkpoint.load(p), jckpt.load(p)):
        assert sorted(got) == sorted([*arrays, "t"])
        for k, v in arrays.items():
            assert got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], v), k
        assert float(got["t"]) == 0.5
    assert not (tmp_path / "ck.npz.tmp").exists() and not (tmp_path / "ck.npz.tmp.npz").exists()


def test_checkpoint_tensor_with_grad(tmp_path):
    x = torch.ones(3, requires_grad=True) * 2.0
    checkpoint.save(tmp_path / "g.npz", x=x)
    assert np.array_equal(checkpoint.load(tmp_path / "g.npz")["x"], [2.0, 2.0, 2.0])


def test_newer_schema_refused(tmp_path):
    p = tmp_path / "new.npz"
    with open(p, "wb") as f:
        np.savez(f, __schema__=checkpoint.SCHEMA + 1, T=np.zeros(2))
    for mod in (checkpoint, jckpt):
        with pytest.raises(ValueError, match="newer than supported"):
            mod.load(p)


def test_stats_match_jax(monkeypatch, rng):
    samples = list(rng.random(7))
    got = timing.stats_of(samples)
    it = iter(samples)
    t = [0.0]

    def clock():  # JAX's timed_stats reads perf_counter twice a rep
        t[0] += next(it) if clock.start else 0.0
        clock.start = not clock.start
        return t[0]

    clock.start = False
    monkeypatch.setattr(jtiming, "time", types.SimpleNamespace(perf_counter=clock))
    want = jtiming.timed_stats(lambda: None, reps=7)
    assert got.row() == pytest.approx(want.row(), rel=1e-12)
    assert [f.name for f in got.__dataclass_fields__.values()] == \
        [f.name for f in want.__dataclass_fields__.values()]


def test_timed_stats_counts_calls():
    calls = []
    st = timing.timed_stats(lambda: calls.append(1), reps=4)
    assert len(calls) == st.reps == 4 and st.min_s <= st.median_s
    assert timing.timed_stats(lambda: None, reps=0).reps == 1


def test_trace_on_cpu(tmp_path):
    with profiling.trace(tmp_path / "tr", device="cpu") as prof:
        with profiling.annotate("fpr_span"):
            torch.ones(64).sum()
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "fpr_span" in text and profiling.device_events(prof) == 0


def test_wall_clock_excludes_warmup(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time=lambda: now[0]))
    wc = profiling.WallClock(warmup_steps=2)
    for dt in (5.0, 5.0, 1.0, 1.0):
        now[0] += dt
        wc.step()
    assert wc.elapsed == 2.0


def test_device_without_a_card():
    """A CUDA device without a card is an error with a message, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        device.resolve("cuda")
    assert device.resolve("cpu").type == "cpu"
    info = device.card_info("cpu")
    assert info["device"] == device.name("cpu") == "cpu" and info["nvidia_smi"] is None
