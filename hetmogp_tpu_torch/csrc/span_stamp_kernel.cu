// Span stamps: the device's clock at a span's boundaries, and the census of
// a CUDA graph's nodes that the span counters read, on Hopper (sm_90a).
//
// span_stamp_kernel is one thread that writes the device's global
// nanosecond timer (%globaltimer) into one slot of a ring of 64-bit
// integers in device memory: slot `slot` of row `*pos` (rows `stride` slots
// apart) when `pos` is given, which is how a captured step finds its row
// (the trainer's device step index, read when the graph replays), else slot
// `slot` itself (the eager spans' ring); a slot outside the ring's `slots`
// is not written.  A span is stamped at its entry, ahead of its work in
// stream order, and at its exit, after it.  The stamps are read back only
// when a report is asked for.
//
// Replaces no Pallas kernel: the JAX package has no device-side spans.  It
// moves 8 bytes, so it is bound by the launch alone (an empty kernel's
// ~5 us on an H100 eagerly, ~1-2 us as a node of a graph).  Its symbol
// names none of the port's hand kernels, and no launch counter counts it.
//
// A trainer's graphs are captured without stamps, so an untraced replay
// launches what it launched before spans existed.  While its graph is
// captured, each span boundary is marked (hetmogp_graph_mark: the nodes the
// next captured node will depend on, the nodes captured so far, and their
// census by class: the port's hand kernels, stamps, library kernels, memset
// and memcpy nodes, other nodes; a hand kernel is a kernel node whose
// function lies in this library).  hetmogp_graph_stamped then clones the
// captured graph and adds a stamp node at each mark, after the mark's
// dependencies and before every later node that depended on them; the
// clone is instantiated on its own and launched (hetmogp_graph_launch) in
// place of the plain graph while spans are on.
//
// The clocks' offset: clock_probe_kernel spins on a flag in mapped host
// memory, stamps %globaltimer when the host raises it and writes the stamp
// back; the host's clock before the flag and after the stamp arrives brackets
// the device's stamp within a PCIe round trip (hetmogp_clock_samples).

#include <cuda_runtime.h>
#include <dlfcn.h>

#include <time.h>

#include <algorithm>
#include <set>
#include <vector>

__global__ void span_stamp_kernel(long long* ring, const long long* pos,
                                  int stride, int slot, long long slots) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long at =
      (pos == nullptr ? 0 : pos[0] * (long long)stride) + slot;
  if (at >= 0 && at < slots) ring[at] = (long long)t;  // else: no stamp
}

// An eager stamp: slot `slot` of `ring`.
extern "C" int hetmogp_span_stamp(long long* ring, int slot, long long slots,
                                  cudaStream_t stream) {
  span_stamp_kernel<<<1, 1, 0, stream>>>(ring, nullptr, 0, slot, slots);
  return (int)cudaGetLastError();
}

namespace {

// the classes of a census, in its output's order
enum NodeClass { HAND, STAMP, LIBRARY, MEMORY, OTHER, CLASSES };

bool in_this_library(const void* fn) {
  Dl_info here, there;
  if (dladdr((const void*)&hetmogp_span_stamp, &here) == 0 ||
      dladdr(fn, &there) == 0) {
    return false;
  }
  return here.dli_fbase == there.dli_fbase;
}

int node_class(cudaGraphNode_t node) {
  cudaGraphNodeType type;
  if (cudaGraphNodeGetType(node, &type) != cudaSuccess) return OTHER;
  if (type == cudaGraphNodeTypeMemcpy || type == cudaGraphNodeTypeMemset) {
    return MEMORY;
  }
  if (type != cudaGraphNodeTypeKernel) return OTHER;
  cudaKernelNodeParams p;
  // a kernel that another runtime or the driver launched (PyTorch's,
  // cuBLAS's) may be unknown to this library's runtime: a library kernel
  if (cudaGraphKernelNodeGetParams(node, &p) != cudaSuccess) return LIBRARY;
  if (p.func == (void*)span_stamp_kernel) return STAMP;
  return in_this_library(p.func) ? HAND : LIBRARY;
}

cudaError_t nodes_of(cudaGraph_t graph, std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  return n ? cudaGraphGetNodes(graph, out->data(), &n) : cudaSuccess;
}

cudaError_t dependencies_of(cudaGraphNode_t node,
                            std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphNodeGetDependencies(node, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  return n ? cudaGraphNodeGetDependencies(node, out->data(), &n)
           : cudaSuccess;
}

// One mark: where a stamp goes in the captured graph.
struct Mark {
  std::vector<cudaGraphNode_t> deps;  // what the next node depends on
  std::set<cudaGraphNode_t> before;   // the nodes captured before it
};

struct Marks {
  cudaGraph_t graph = nullptr;  // the graph under capture
  std::vector<Mark> marks;
};

__global__ void clock_probe_kernel(const volatile int* go,
                                   volatile long long* out) {
  while (*go == 0) {
  }
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = (long long)t;
  __threadfence_system();
}

long long host_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);  // Python's time.perf_counter_ns
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

}  // namespace

extern "C" void* hetmogp_marks_new() { return new Marks(); }

extern "C" void hetmogp_marks_free(void* marks) {
  delete static_cast<Marks*>(marks);
}

// Marks the next boundary of the graph `stream` is capturing into, and
// writes the graph's census so far into counts[CLASSES]; an error where the
// stream captures nothing or into another graph than the marks' first.
extern "C" int hetmogp_graph_mark(void* marks, cudaStream_t stream,
                                  long long* counts) {
  Marks* m = static_cast<Marks*>(marks);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                             &graph, &deps, &ndeps);
  if (err == cudaSuccess && (status != cudaStreamCaptureStatusActive ||
                             graph == nullptr ||
                             (m->graph != nullptr && graph != m->graph))) {
    err = cudaErrorStreamCaptureUnmatched;
  }
  Mark mark;
  std::vector<cudaGraphNode_t> nodes;
  if (err == cudaSuccess) {
    mark.deps.assign(deps, deps + ndeps);
    err = nodes_of(graph, &nodes);
  }
  if (err == cudaSuccess) {
    for (int c = 0; c < CLASSES; ++c) counts[c] = 0;
    for (cudaGraphNode_t node : nodes) counts[node_class(node)] += 1;
    mark.before.insert(nodes.begin(), nodes.end());
    m->graph = graph;
    m->marks.push_back(std::move(mark));
  }
  cudaGetLastError();  // a failed query must not stay behind as a launch error
  return (int)err;
}

// Clones `graph` (captured with the marks), adds a stamp node at each of the
// first `stride` marks (mark b writes slot b of row *pos of `ring`, which has
// `slots` slots), and instantiates the clone: *clone_out and *exec_out.  A
// stamp runs after its mark's dependencies (and after the stamp of an earlier
// mark at the same place) and before every node captured after the mark
// that depended on them.
extern "C" int hetmogp_graph_stamped(void* marks, cudaGraph_t graph,
                                     long long* ring, const long long* pos,
                                     int stride, long long slots,
                                     cudaGraph_t* clone_out,
                                     cudaGraphExec_t* exec_out) {
  const Marks* m = static_cast<const Marks*>(marks);
  *clone_out = nullptr;
  *exec_out = nullptr;
  std::vector<cudaGraphNode_t> nodes;
  cudaGraph_t clone = nullptr;
  cudaError_t err = nodes_of(graph, &nodes);
  if (err == cudaSuccess) err = cudaGraphClone(&clone, graph);
  std::vector<std::vector<cudaGraphNode_t>> deps_of(nodes.size());
  for (size_t i = 0; err == cudaSuccess && i < nodes.size(); ++i) {
    err = dependencies_of(nodes[i], &deps_of[i]);
  }
  cudaGraphNode_t previous = nullptr;  // the stamp of the last mark
  size_t previous_size = 0;
  for (size_t b = 0; err == cudaSuccess && b < m->marks.size() &&
                     b < (size_t)stride; ++b) {
    const Mark& mark = m->marks[b];
    std::vector<cudaGraphNode_t> after;  // the stamp's dependencies
    for (size_t k = 0; err == cudaSuccess && k < mark.deps.size(); ++k) {
      cudaGraphNode_t c = nullptr;
      err = cudaGraphNodeFindInClone(&c, mark.deps[k], clone);
      after.push_back(c);
    }
    if (previous != nullptr && mark.before.size() == previous_size) {
      after.push_back(previous);  // nothing captured since the last stamp
    }
    int slot = (int)b;
    long long* ring_arg = ring;
    const long long* pos_arg = pos;
    void* args[] = {&ring_arg, &pos_arg, &stride, &slot, &slots};
    cudaKernelNodeParams p = {};
    p.func = (void*)span_stamp_kernel;
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.kernelParams = args;
    cudaGraphNode_t stamp = nullptr;
    if (err == cudaSuccess) {
      err = cudaGraphAddKernelNode(&stamp, clone, after.data(), after.size(),
                                   &p);
    }
    for (size_t i = 0; err == cudaSuccess && i < nodes.size(); ++i) {
      if (mark.before.count(nodes[i])) continue;
      bool follows = deps_of[i].empty() && mark.deps.empty();
      for (cudaGraphNode_t d : deps_of[i]) {
        follows = follows || std::find(mark.deps.begin(), mark.deps.end(),
                                       d) != mark.deps.end();
      }
      if (!follows) continue;
      cudaGraphNode_t c = nullptr;
      err = cudaGraphNodeFindInClone(&c, nodes[i], clone);
      if (err == cudaSuccess) err = cudaGraphAddDependencies(clone, &stamp, &c, 1);
    }
    previous = stamp;
    previous_size = mark.before.size();
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, clone, 0);
  if (err != cudaSuccess && clone != nullptr) {
    cudaGraphDestroy(clone);
    clone = nullptr;
  }
  *clone_out = clone;
  *exec_out = exec;
  cudaGetLastError();
  return (int)err;
}

extern "C" int hetmogp_graph_launch(cudaGraphExec_t exec,
                                    cudaStream_t stream) {
  return (int)cudaGraphLaunch(exec, stream);
}

extern "C" void hetmogp_graph_free(cudaGraph_t graph, cudaGraphExec_t exec) {
  if (exec != nullptr) cudaGraphExecDestroy(exec);
  if (graph != nullptr) cudaGraphDestroy(graph);
}

// n samples of the clocks: host_before[i] <= the host's time at device[i]
// (the device's %globaltimer) <= host_after[i], host times by
// CLOCK_MONOTONIC.  Each sample launches clock_probe_kernel on `stream`
// (which must be idle), lets it reach its loop, raises its flag and waits
// for its stamp.
extern "C" int hetmogp_clock_samples(int n, long long* host_before,
                                     long long* device, long long* host_after,
                                     cudaStream_t stream) {
  int* go = nullptr;
  long long* out = nullptr;
  cudaError_t err = cudaHostAlloc((void**)&go, sizeof(int),
                                  cudaHostAllocMapped);
  if (err == cudaSuccess) {
    err = cudaHostAlloc((void**)&out, sizeof(long long), cudaHostAllocMapped);
  }
  int* dgo = nullptr;
  long long* dout = nullptr;
  if (err == cudaSuccess) err = cudaHostGetDevicePointer((void**)&dgo, go, 0);
  if (err == cudaSuccess) err = cudaHostGetDevicePointer((void**)&dout, out, 0);
  volatile int* vgo = go;
  volatile long long* vout = out;
  for (int i = 0; err == cudaSuccess && i < n; ++i) {
    *vgo = 0;
    *vout = -1;
    __sync_synchronize();
    clock_probe_kernel<<<1, 1, 0, stream>>>(dgo, dout);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    const long long t = host_ns();
    while (host_ns() - t < 200000) {  // the kernel reaches its loop
    }
    host_before[i] = host_ns();
    *vgo = 1;
    __sync_synchronize();
    while (*vout == -1 && host_ns() - host_before[i] < 1000000000LL) {
    }
    host_after[i] = host_ns();
    device[i] = *vout;
    err = cudaStreamSynchronize(stream);
  }
  if (go != nullptr) cudaFreeHost(go);
  if (out != nullptr) cudaFreeHost(out);
  cudaGetLastError();
  return (int)err;
}
