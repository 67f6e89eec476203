// The on-device loops of fpr_tpu_torch/core/loops.py: CUDA graphs with
// conditional nodes (CUDA >= 12.4), the counterpart of jax.lax.while_loop.
//
// Replaces no TPU kernel: on the TPU, XLA compiles lax.while_loop into the
// program and its predicate never leaves the chip.  Here the loop body is
// captured by PyTorch (torch.cuda.CUDAGraph, keep_graph=True) in segments,
// and this file assembles them: each segment becomes a child-graph node, a
// loop a WHILE node whose body graph holds the body's segments, and an
// unrolled loop's second pass an IF node inside it.  The predicate of each
// conditional node is an int32 on the device, written by the captured cond;
// a one-thread kernel copies it into the node's handle
// (cudaGraphSetConditional), from the graph that owns the handle, and adds
// one to a pass counter (the launch accounting of loops.py) where it is given
// one.  Nothing is read on the host between the graph's launch and its end.
//
// Bound: none of its own.  The set kernel is one thread; what a loop costs
// beyond its body is that kernel and the conditional node's scheduling, a
// few microseconds a pass on an H100 (PERF.md).
//
// Every entry point returns a cudaError_t as an int (0 is success) and takes
// the graph objects as opaque pointers, so that the graphs PyTorch captured
// (raw_cuda_graph()) and the streams it launches on pass through ctypes.
#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const int* pred,
                                     unsigned long long* passes) {
    cudaGraphSetConditional(handle, *pred != 0 ? 1u : 0u);
    if (passes != nullptr) *passes += 1ull;
}

cudaError_t add_set(cudaGraph_t graph, cudaGraphNode_t dep, cudaGraphConditionalHandle handle,
                    const int* pred, unsigned long long* passes, cudaGraphNode_t* node) {
    void* args[3] = {&handle, &pred, &passes};
    cudaKernelNodeParams p = {};
    p.func = reinterpret_cast<void*>(set_condition_kernel);
    p.gridDim = dim3(1, 1, 1);
    p.blockDim = dim3(1, 1, 1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    p.extra = nullptr;
    return cudaGraphAddKernelNode(node, graph, dep != nullptr ? &dep : nullptr, dep != nullptr ? 1 : 0,
                                  &p);
}

}  // namespace

extern "C" {

int fpr_graph_create(void** graph) {
    return static_cast<int>(cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0));
}

int fpr_graph_destroy(void* graph) {
    return static_cast<int>(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
}

int fpr_graph_nodes(void* graph, size_t* n) {
    return static_cast<int>(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, n));
}

// child (a captured segment, cloned into graph) after dep (none if null).
int fpr_graph_add_child(void* graph, void* dep, void* child, void** node) {
    cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
    return static_cast<int>(cudaGraphAddChildGraphNode(
        reinterpret_cast<cudaGraphNode_t*>(node), static_cast<cudaGraph_t>(graph),
        d != nullptr ? &d : nullptr, d != nullptr ? 1 : 0, static_cast<cudaGraph_t>(child)));
}

// A conditional node of `type` (0: IF, 1: WHILE) in graph after dep: a new
// handle owned by graph, the set kernel from pred (an int32 on the device)
// before the node, and the node; returns the node, its (empty) body graph
// and the handle, which a set kernel inside the body may set again (WHILE).
int fpr_graph_add_cond(void* graph, void* dep, int type, const void* pred, void** node,
                       void** body, unsigned long long* handle) {
    cudaGraph_t g = static_cast<cudaGraph_t>(graph);
    cudaGraphConditionalHandle h;
    cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphNode_t set = nullptr;
    err = add_set(g, static_cast<cudaGraphNode_t>(dep), h, static_cast<const int*>(pred), nullptr,
                  &set);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h;
    p.conditional.type = type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t n = nullptr;
    err = cudaGraphAddNode(&n, g, &set, 1, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
    *node = n;
    *body = p.conditional.phGraph_out[0];
    *handle = h;
    return 0;
}

// The set kernel alone, in graph after dep: the handle from pred, and one
// more pass in *passes unless passes is null.
int fpr_graph_add_set(void* graph, void* dep, unsigned long long handle, const void* pred,
                      void* passes, void** node) {
    return static_cast<int>(add_set(static_cast<cudaGraph_t>(graph),
                                    static_cast<cudaGraphNode_t>(dep), handle,
                                    static_cast<const int*>(pred),
                                    static_cast<unsigned long long*>(passes),
                                    reinterpret_cast<cudaGraphNode_t*>(node)));
}

int fpr_graph_instantiate(void* graph, void** exec) {
    return static_cast<int>(cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                                                 static_cast<cudaGraph_t>(graph), 0));
}

int fpr_graph_launch(void* exec, void* stream) {
    return static_cast<int>(
        cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int fpr_graph_exec_destroy(void* exec) {
    return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
