// IF and WHILE nodes for CUDA graphs captured by PyTorch (ops/cuda_graphs.py).
//
// The device-resident Newton loop (solvers/device_loop.py) and the PCG
// chunks (solvers/linear.py::DevicePCGChunk) replay graphs whose control is
// decided on the card: a body runs only while a flag in device memory is
// set. CUDA has conditional nodes for that (IF since CUDA 12.3, WHILE since
// 12.4); the PyTorch this runs under captures graphs but has no call that
// captures into one. So PyTorch captures each body as a graph of its own
// (its memory in that graph's private pool), and this library composes the
// programs from them: a chain whose items are a child-graph node holding a
// body, or
//
//     IF:    set kernel (reads the flag, sets the IF's condition) -> IF node
//            {chain}
//     WHILE: set kernel -> WHILE node {chain -> set kernel}
//
// where {chain} is again a chain of items, appended into the conditional
// node's own body graph, so that conditionals nest (a whole Newton
// increment: WHILE {..., IF {...}, WHILE {...}, ...}). A child graph may
// not hold a conditional node (cudaGraphAddChildGraphNode refuses it), so a
// composed program is never wrapped as a child graph. The WHILE item is
// `lax.while_loop`: the flag is tested before the first run (a flag already
// clear runs the body no time) and again after each run, all on the card.
// cudaGraphAddChildGraphNode clones the body, so a body may appear several
// times in one program (the two runs of a PCG solve and its restart). No
// Pallas kernel of the reference corresponds: on the TPU the loops are XLA
// programs. The set kernel is one thread that reads one byte.
//
// The span stamp (utils/profiling.py) is one thread too: it reads
// %globaltimer, the card's nanosecond clock (the one CUPTI stamps a trace's
// kernels with), closes the span open on the card and opens the next. A
// captured body starts with one, so its span's count is its runs.
//
// A conditional node's body graph takes kernel, memset, memcpy, empty,
// child-graph and conditional nodes only; fea_graph_refused names the first
// node of another type in a body (the sharded ranks' bodies hold the
// collectives' captured nodes).
//
// C interface, loaded with ctypes; every function returns a cudaError_t.

#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// table: int64 [spans, 2] (runs, nanoseconds) of each span; open: int64
// [2], the open span (-1: none) and the clock when it opened; runs: a
// body's run counter to increment, or null.
__global__ void stamp_kernel(long long* table, long long* open, int next, long long* runs) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  const long long was = open[0];
  if (was >= 0) {
    table[2 * was] += 1;
    table[2 * was + 1] += t - open[1];
  }
  open[0] = next;
  open[1] = t;
  if (runs != nullptr) *runs += 1;
}

cudaError_t add_node(cudaGraphNode_t* out, cudaGraph_t graph, const cudaGraphNode_t* deps,
                     size_t n_deps, cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(out, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(out, graph, deps, n_deps, params);
#endif
}

#define FEA_TRY(call)                         \
  do {                                        \
    cudaError_t status_ = (call);             \
    if (status_ != cudaSuccess) return status_; \
  } while (0)

// The item kinds of fea_graph_compose.
enum Kind { kAlways = 0, kIf = 1, kWhile = 2 };

// A set kernel node in `graph` after `deps` (n_deps of them): it copies
// *flag into the condition `handle`.
cudaError_t add_set(cudaGraphNode_t* out, cudaGraph_t graph, const cudaGraphNode_t* deps,
                    size_t n_deps, cudaGraphConditionalHandle handle, const bool* flag) {
  void* args[2] = {&handle, &flag};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return cudaGraphAddKernelNode(out, graph, deps, n_deps, &kp);
}

// Append a set kernel and a conditional node of `kind` on *flag to the
// chain of `graph` ending at *tail; *inner is the node's body graph.
cudaError_t append_conditional(cudaGraph_t graph, cudaGraphNode_t* tail, const bool* flag,
                               int kind, cudaGraph_t* inner, cudaGraphConditionalHandle* handle) {
  // the handle belongs to the graph that holds the conditional node
  FEA_TRY(cudaGraphConditionalHandleCreate(handle, graph, 0, 0));
  cudaGraphNode_t set;
  FEA_TRY(add_set(&set, graph, tail, *tail ? 1 : 0, *handle, flag));
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = *handle;
  cp.conditional.type = kind == kIf ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  FEA_TRY(add_node(tail, graph, &set, 1, &cp));
  *inner = cp.conditional.phGraph_out[0];
  return cudaSuccess;
}

// Append items [lo, hi), the chain whose parent is item `parent` (-1: the
// top level), to the chain of `graph` ending at *tail. Items are in
// pre-order: item i's chain is the run of items after it whose parents are
// i or later.
cudaError_t append_chain(cudaGraph_t graph, cudaGraphNode_t* tail, int parent, int lo, int hi,
                         void* const* bodies, void* const* flags, const int* kinds,
                         const int* parents) {
  for (int i = lo; i < hi;) {
    if (parents[i] != parent) return cudaErrorInvalidValue;
    int end = i + 1;
    while (end < hi && parents[end] >= i) {
      if (parents[end] >= end) return cudaErrorInvalidValue;
      ++end;
    }
    if (kinds[i] == kAlways) {
      if (bodies[i] == nullptr || end != i + 1) return cudaErrorInvalidValue;
      cudaGraphNode_t node;
      FEA_TRY(cudaGraphAddChildGraphNode(&node, graph, tail, *tail ? 1 : 0,
                                         static_cast<cudaGraph_t>(bodies[i])));
      *tail = node;
    } else {
      const bool* flag = static_cast<const bool*>(flags[i]);
      if ((kinds[i] != kIf && kinds[i] != kWhile) || flag == nullptr || bodies[i] != nullptr ||
          end == i + 1) {
        return cudaErrorInvalidValue;
      }
      cudaGraph_t inner;
      cudaGraphConditionalHandle handle;
      FEA_TRY(append_conditional(graph, tail, flag, kinds[i], &inner, &handle));
      cudaGraphNode_t inner_tail = nullptr;
      FEA_TRY(append_chain(inner, &inner_tail, i, i + 1, end, bodies, flags, kinds, parents));
      if (kinds[i] == kWhile) {
        // the loop condition for the next run, after this one
        cudaGraphNode_t again;
        FEA_TRY(add_set(&again, inner, &inner_tail, 1, handle, flag));
      }
    }
    i = end;
  }
  return cudaSuccess;
}

// The name of a node type that a conditional node's body refuses, or
// nullptr for one it takes.
const char* refused_type(cudaGraphNodeType type) {
  switch (type) {
    case cudaGraphNodeTypeKernel:
    case cudaGraphNodeTypeMemcpy:
    case cudaGraphNodeTypeMemset:
    case cudaGraphNodeTypeGraph:
    case cudaGraphNodeTypeEmpty:
    case cudaGraphNodeTypeConditional:
      return nullptr;
    case cudaGraphNodeTypeHost:
      return "host";
    case cudaGraphNodeTypeWaitEvent:
      return "event wait";
    case cudaGraphNodeTypeEventRecord:
      return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal:
      return "external semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait:
      return "external semaphore wait";
    case cudaGraphNodeTypeMemAlloc:
      return "memory allocation";
    case cudaGraphNodeTypeMemFree:
      return "memory free";
    default:
      return "unknown";
  }
}

// The first node of `graph` (its child graphs included) of a type that a
// conditional node's body refuses: *name its type's name, or nullptr.
cudaError_t first_refused(cudaGraph_t graph, const char** name) {
  *name = nullptr;
  size_t n = 0;
  FEA_TRY(cudaGraphGetNodes(graph, nullptr, &n));
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) FEA_TRY(cudaGraphGetNodes(graph, nodes.data(), &n));
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    FEA_TRY(cudaGraphNodeGetType(node, &type));
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      FEA_TRY(cudaGraphChildGraphNodeGetGraph(node, &child));
      FEA_TRY(first_refused(child, name));
    } else {
      *name = refused_type(type);
    }
    if (*name != nullptr) return cudaSuccess;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Load the set kernel's module now: a first launch inside a capture or a
// graph cannot load it.
int fea_graph_init() {
  cudaFuncAttributes attr;
  cudaError_t status = cudaFuncGetAttributes(&attr, set_condition_kernel);
  return status != cudaSuccess ? status : cudaFuncGetAttributes(&attr, stamp_kernel);
}

// Launch the span stamp on `stream` (captured where the stream captures):
// close the span open in `open`, adding it to `table`, open span `next`
// (-1: none) and add one to *runs where runs is not null.
int fea_span_stamp(void* table, void* open, int next, void* runs, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(table), static_cast<long long*>(open), next,
      static_cast<long long*>(runs));
  return cudaGetLastError();
}

// Compose n items into a new graph and instantiate it. The items are in
// pre-order; parents[i] is the conditional item whose chain item i belongs
// to (-1: the top level). Item i is the body graph bodies[i], run once
// (kinds[i] 0), or a conditional on the bool *flags[i] in device memory,
// read when a set kernel runs, with bodies[i] null: IF (1) or WHILE (2)
// over its chain, which is not empty.
int fea_graph_compose(int n, void* const* bodies, void* const* flags, const int* kinds,
                      const int* parents, void** graph_out, void** exec_out) {
  cudaGraph_t graph;
  FEA_TRY(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t tail = nullptr;
  cudaError_t status = append_chain(graph, &tail, -1, 0, n, bodies, flags, kinds, parents);
  if (status != cudaSuccess) {
    cudaGraphDestroy(graph);
    return status;
  }
  cudaGraphExec_t exec;
  status = cudaGraphInstantiate(&exec, graph, 0);
  if (status != cudaSuccess) {
    cudaGraphDestroy(graph);
    return status;
  }
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
}

// Append the graph `child` as a child-graph node to a new graph and
// destroy that graph: whether CUDA takes `child` as a child graph (it
// refuses one that holds a conditional node).
int fea_graph_try_child(void* child) {
  cudaGraph_t graph;
  FEA_TRY(cudaGraphCreate(&graph, 0));
  cudaGraphNode_t node;
  cudaError_t status = cudaGraphAddChildGraphNode(&node, graph, nullptr, 0,
                                                  static_cast<cudaGraph_t>(child));
  cudaGraphDestroy(graph);
  // the refusal is the answer, not a fault: clear it, so that the next
  // launch's cudaGetLastError (the span stamp's) does not report it
  cudaGetLastError();
  return status;
}

// Into out (len bytes): the name of the first node type in `graph` that a
// conditional node's body refuses, or "" where it takes every node.
int fea_graph_refused(void* graph, char* out, int len) {
  const char* name = nullptr;
  out[0] = 0;
  FEA_TRY(first_refused(static_cast<cudaGraph_t>(graph), &name));
  if (name != nullptr) snprintf(out, len, "%s", name);
  return cudaSuccess;
}

int fea_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

// Top-level nodes of a graph (a body captured by PyTorch has no nested one).
int fea_graph_node_count(void* graph, size_t* count) {
  return cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, count);
}

int fea_graph_destroy(void* graph, void* exec) {
  cudaError_t a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return a != cudaSuccess ? a : b;
}

}  // extern "C"
