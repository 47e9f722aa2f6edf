// Kernel 6, redesigned: the ELBO's likelihood term of every task of a step
// in one launch, and its gradient in one more, on Hopper (sm_90a), float32
// and float64.
//
// For each task t of the table, with moments m, v (N_t, J_t), observations
// y (N_t, dim_y), a row mask and a scale (a device scalar):
//   ve[n]    = E_{N(m_n, v_n)}[log p(y_n | f)]       (finish_row, gh_sweep.cuh)
//   coef[n]  = (dve/dm_n, dve/dv_n)                  (2 J_t a row)
//   sum[t]   = scale_t sum_n mask_n ve[n]
// and the backward launch, from the upstream gradient g of the sums,
//   dM_t[n] = (g_t scale_t) mask_n c_m[n],  dV_t[n] = (g_t scale_t) mask_n c_v[n].
// The families are gh_sweep.cuh's task table: Bernoulli and Categorical
// (a GH sweep alone), HetGaussian, Poisson and Exponential (a closed form
// alone), Gamma (a closed form around LnGamma's sweep), and the multi-term
// families Beta and Dirichlet (a closed form around several sweeps, each
// on its own node table), Binomial (n a constant of the task) and the
// zero-inflated Poisson: a row's lanes take its terms' nodes one after
// another, each node adding into its own term's accumulators.
//
// Replaces no Pallas kernel: it is the JAX package's likelihood term,
// hetmogp_tpu/models/elbo.py:442-454 (each task's var_exp and its masked,
// scaled sum, with make_var_exp's fused ve_fwd, hetmogp_tpu/ops/
// quadrature.py:129-146, for the swept engines), which XLA compiles into
// the step's one program on the TPU.  The per-engine design
// (gh_sweep_kernel.cu) launched one sweep an engine and left the closed
// forms, the masked sums and their backward to some 190 small torch
// kernels a step.
//
// What bounds it on an H100: neither bytes nor operations.  A step's six
// tasks are 3,072 rows (768 in the VM step): ~0.12 MB and ~9 MFLOP, a
// fraction of a microsecond of either.  The launch and the longest
// dependent chain of a row are the cost, so the design spends everything
// on one launch with short chains:
//   * one grid over the rows of every task: the task table is passed by
//     value (__grid_constant__), each task owning a run of blocks, so a
//     block is one task's and its family switch is uniform;
//   * L lanes a row, L chosen by the wrapper from the node count (one node
//     a lane where the block has room for it: T = 20 gives 12 rows of 20
//     lanes a block, Categorical's 100 nodes 2 rows of 100), a closed form
//     one thread a row; the lanes' node sums meet in a fixed tree in
//     shared memory (tree_top);
//   * the row's lane 0 finishes it (finish_row: the closed form on a
//     first-order jet), writes its value and coefficients and its masked
//     value; the block adds its rows' in a fixed tree and writes a
//     partial; a ticket counter elects the task's last block, which adds
//     the task's partials in block order (each thread a strided run, then
//     a fixed tree) and writes scale_t times the sum.  No atomics on
//     values: two launches, and graphed and eager steps, are bitwise equal.
// The nodes are rounded as the plain engine rounds them (mul_rn, add_rn);
// no fast-math.

#include <cuda_runtime.h>
#include <string.h>

#include "gh_sweep.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TASKS = 16;
// a multi-term family's terms, and a task's constants, at most
constexpr int MAX_TERMS = 4;
constexpr int MAX_CONSTS = 2;
// the table's integers a task: sy, sm, sv, smask, family, J, lanes, S, N,
// the terms' node counts, the constants' float64 bits
constexpr int INTS = 9 + MAX_TERMS + MAX_CONSTS;
// its pointers: y, m, v, mask, scale, nodes, w, val, coef, sum
constexpr int PTRS = 10;

struct Task {
  const void* y;
  const void* m;
  const void* v;
  const void* mask;
  const void* scale;
  const void* nodes;
  const void* w;
  void* val;
  void* coef;  // null: the value alone
  void* sum;
  long long sy, sm, sv, smask;
  int family, J, lanes, S, N;
  int rows;  // rows a block: THREADS / lanes
  int first_block, blocks;
  int sizes[MAX_TERMS];  // a multi-term family's node counts, in its order
  double c[MAX_CONSTS];  // the constants
};

struct Table {
  Task task[MAX_TASKS];
  int count;
  void* partials;  // a T a block of the grid
};

// A task's ticket: each block of the task takes one after writing its
// partial; the last takes the task's sum and puts it back to 0, so every
// launch starts and ends with the tickets at 0.  Launches of one process on
// one device must not overlap.
__device__ unsigned int task_ticket[MAX_TASKS];

// The fixed tree of gh::tree_top over L entries x[base + 0 .. L) of every
// group, a level between two barriers; every thread of the block calls it
// with the same L (lane >= L: not in a group).
template <typename T, int A>
__device__ __forceinline__ void shared_tree(T (*x)[THREADS], int lane,
                                            int base, int L) {
  for (int off = gh::tree_top(L); off > 0; off /= 2) {
    if (lane < off && lane + off < L) {
#pragma unroll
      for (int a = 0; a < A; ++a) x[a][base + lane] += x[a][base + lane + off];
    }
    __syncthreads();
  }
}

// One block's rows of task e: the row values and coefficients, and the
// block's masked sum of them, returned to thread 0.
template <typename Fam, typename T, bool DERIV, int A>
__device__ __forceinline__ T task_block(const Task& e, T (*part)[THREADS]) {
  constexpr int J = Fam::J;
  constexpr int FA = gh::task_acc_size<Fam, DERIV>();
  static_assert(FA <= A, "the shared accumulators are too narrow");
  const int L = e.lanes;
  const int tid = threadIdx.x;
  const int local = tid / L;
  const int lane = tid - local * L;
  const int row0 = (blockIdx.x - e.first_block) * e.rows;
  const int n_rows = min(e.rows, e.N - row0);
  const bool active = local < n_rows;
  const long long row = row0 + local;
  const T* m = static_cast<const T*>(e.m) + row * e.sm;
  const T* v = static_cast<const T*>(e.v) + row * e.sv;
  const T* y = static_cast<const T*>(e.y) + row * e.sy;
  T c[MAX_CONSTS];
#pragma unroll
  for (int i = 0; i < MAX_CONSTS; ++i) c[i] = T(e.c[i]);
  T acc[FA];
#pragma unroll
  for (int a = 0; a < FA; ++a) acc[a] = T(0);
  if constexpr (gh::task_sweeps<Fam>()) {
    if (active) {
      gh::task_nodes<Fam, T, DERIV>(m, v, y, c, static_cast<const T*>(e.nodes),
                                    static_cast<const T*>(e.w), e.S, e.sizes,
                                    lane, L, acc);
    }
    if (L > 1) {
#pragma unroll
      for (int a = 0; a < FA; ++a) part[a][tid] = acc[a];
      __syncthreads();
      shared_tree<T, FA>(part, active ? lane : L, local * L, L);
#pragma unroll
      for (int a = 0; a < FA; ++a) acc[a] = part[a][tid];
      __syncthreads();  // part is rewritten below
    }
  }
  if (active && lane == 0) {
    T coef[DERIV ? 2 * J : 1];
    const T val = gh::finish_row<Fam, T, DERIV>(m, v, y, c, acc, coef);
    static_cast<T*>(e.val)[row] = val;
    if constexpr (DERIV) {
      T* out = static_cast<T*>(e.coef) + row * (2 * J);
#pragma unroll
      for (int k = 0; k < 2 * J; ++k) out[k] = coef[k];
    }
    part[0][local] = static_cast<const T*>(e.mask)[row * e.smask] * val;
  }
  __syncthreads();
  shared_tree<T, 1>(part, tid < n_rows ? tid : n_rows, 0, n_rows);
  return part[0][0];
}

// TERMS: the multi-term families too (codes 6 to 9), compiled only into the
// instantiations that a table holding one of them selects
template <typename T, bool DERIV, int A, bool TERMS>
__device__ __forceinline__ T dispatch_block(const Task& e, T (*part)[THREADS]) {
  switch (e.family) {
    case 0: return task_block<gh::BernoulliTask<T>, T, DERIV, A>(e, part);
    case 1:
      // Categorical's J up to (A - 1) / 2 with the derivatives, 5 without
      switch (e.J) {
        case 1: return task_block<gh::CategoricalTask<T, 2>, T, DERIV, A>(e, part);
        case 2: if constexpr (!DERIV || A >= 5) return task_block<gh::CategoricalTask<T, 3>, T, DERIV, A>(e, part); break;
        case 3: if constexpr (!DERIV || A >= 7) return task_block<gh::CategoricalTask<T, 4>, T, DERIV, A>(e, part); break;
        case 4: if constexpr (!DERIV || A >= 9) return task_block<gh::CategoricalTask<T, 5>, T, DERIV, A>(e, part); break;
        case 5: if constexpr (!DERIV || A >= 11) return task_block<gh::CategoricalTask<T, 6>, T, DERIV, A>(e, part); break;
        default: break;
      }
      break;
    case 2: return task_block<gh::HetGaussianTask<T>, T, DERIV, A>(e, part);
    case 3: return task_block<gh::PoissonTask<T>, T, DERIV, A>(e, part);
    case 4: return task_block<gh::GammaTask<T>, T, DERIV, A>(e, part);
    case 5: return task_block<gh::ExponentialTask<T>, T, DERIV, A>(e, part);
    case 6: if constexpr (TERMS) return task_block<gh::BetaTask<T>, T, DERIV, A>(e, part); break;
    case 7: if constexpr (TERMS) return task_block<gh::BinomialTask<T>, T, DERIV, A>(e, part); break;
    case 8:
      if constexpr (TERMS) {
        switch (e.J) {
          case 2: return task_block<gh::DirichletTask<T, 2>, T, DERIV, A>(e, part);
          case 3: return task_block<gh::DirichletTask<T, 3>, T, DERIV, A>(e, part);
          default: break;
        }
      }
      break;
    case 9: if constexpr (TERMS) return task_block<gh::ZipTask<T>, T, DERIV, A>(e, part); break;
    default: break;
  }
  __trap();  // the host checks the table
  return T(0);
}

// A = the widest sweep accumulator the launch may meet: 1 + 2 J of its
// widest Categorical (3 for the other sweeps) with the derivatives, 1
// without; with TERMS, a multi-term family's, all its terms' (Dirichlet
// K = 3: 16 with the derivatives, 4 without).  The shared accumulators,
// and the registers of the widest family's jets, size the whole kernel, so
// the flagship's K = 3 does not pay for K = 6, nor a table without a
// multi-term family for them.
template <typename T, bool DERIV, int A, bool TERMS>
__global__ void __launch_bounds__(THREADS)
    ve_tasks_kernel(const __grid_constant__ Table table) {
  __shared__ T part[A][THREADS];
  __shared__ bool last;
  int t = 0;
  while (t + 1 < table.count &&
         (int)blockIdx.x >= table.task[t + 1].first_block) {
    ++t;
  }
  const Task& e = table.task[t];
  const T block_sum = dispatch_block<T, DERIV, A, TERMS>(e, part);
  T* partials = static_cast<T*>(table.partials);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block_sum;
    __threadfence();
    last = atomicAdd(task_ticket + t, 1u) == (unsigned)(e.blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the task's partials in block order: thread i adds partials i, i +
  // THREADS, ..., then the fixed tree over the threads
  T s = T(0);
  for (int i = threadIdx.x; i < e.blocks; i += THREADS) {
    s += __ldcg(partials + e.first_block + i);
  }
  const int n = min(e.blocks, THREADS);
  part[0][threadIdx.x] = s;
  __syncthreads();
  shared_tree<T, 1>(part, threadIdx.x < n ? (int)threadIdx.x : n, 0, n);
  if (threadIdx.x == 0) {
    *static_cast<T*>(e.sum) = *static_cast<const T*>(e.scale) * part[0][0];
    task_ticket[t] = 0u;
  }
}

// ---- the backward launch -------------------------------------------------------

// the pointers a task: coef, mask, scale, g, dm, dv
constexpr int GRAD_PTRS = 6;
// the integers: smask, J, N
constexpr int GRAD_INTS = 3;

struct GradTask {
  const void* coef;
  const void* mask;
  const void* scale;
  const void* g;
  void* dm;
  void* dv;
  long long smask;
  int J, N, first_block;
};

struct GradTable {
  GradTask task[MAX_TASKS];
  int count;
};

// One thread a row: dM[n, j] = c_m[n, j] ((g scale) mask_n), dV likewise,
// the plain backward's products in its order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ve_tasks_grad_kernel(const __grid_constant__ GradTable table) {
  int t = 0;
  while (t + 1 < table.count &&
         (int)blockIdx.x >= table.task[t + 1].first_block) {
    ++t;
  }
  const GradTask& e = table.task[t];
  const long long row =
      (long long)(blockIdx.x - e.first_block) * THREADS + threadIdx.x;
  if (row >= e.N) return;
  const T gs = *static_cast<const T*>(e.g) * *static_cast<const T*>(e.scale);
  const T gm = gs * static_cast<const T*>(e.mask)[row * e.smask];
  const T* c = static_cast<const T*>(e.coef) + row * 2 * e.J;
  T* dm = static_cast<T*>(e.dm) + row * e.J;
  T* dv = static_cast<T*>(e.dv) + row * e.J;
  for (int j = 0; j < e.J; ++j) {
    dm[j] = c[j] * gm;
    dv[j] = c[e.J + j] * gm;
  }
}

// Whether the kernel has family `family` at J latent dimensions (the codes
// of dispatch_block).
int family_ok(int family, int J) {
  switch (family) {
    case 0: return J == 1;
    case 1: return J >= 1 && J <= 5;
    case 2: return J == 2;
    case 3: return J == 1;
    case 4: return J == 2;
    case 5: return J == 1;
    case 6: return J == 2;
    case 7: return J == 1;
    case 8: return J == 2 || J == 3;
    case 9: return J == 2;
    default: return 0;
  }
}

// The terms of a multi-term family at J (codes 6 to 9), 0 for the others
int terms_of(int family, int J) {
  switch (family) {
    case 6: return 3;
    case 7: return 1;
    case 8: return J + 1;
    case 9: return 1;
    default: return 0;
  }
}

bool has_sweep(int family) {
  return family == 0 || family == 1 || family == 4 ||
         (family >= 6 && family <= 9);
}

// The table from the packed pointers and integers, its blocks planned;
// the number of blocks, or -1 for a table the kernel does not take.
long long plan(const void* const* ptrs, const long long* ints, int tasks,
               bool deriv, Table& table, int& widest, bool& terms) {
  if (tasks <= 0 || tasks > MAX_TASKS) return -1;
  long long blocks = 0;
  widest = 0;
  terms = false;
  table.count = tasks;
  for (int t = 0; t < tasks; ++t) {
    const void* const* p = ptrs + PTRS * t;
    const long long* q = ints + INTS * t;
    Task& e = table.task[t];
    e.y = p[0]; e.m = p[1]; e.v = p[2]; e.mask = p[3]; e.scale = p[4];
    e.nodes = p[5]; e.w = p[6];
    e.val = const_cast<void*>(p[7]);
    e.coef = const_cast<void*>(p[8]);
    e.sum = const_cast<void*>(p[9]);
    e.sy = q[0]; e.sm = q[1]; e.sv = q[2]; e.smask = q[3];
    e.family = (int)q[4]; e.J = (int)q[5]; e.lanes = (int)q[6];
    e.S = (int)q[7];
    for (int k = 0; k < MAX_TERMS; ++k) e.sizes[k] = (int)q[9 + k];
    for (int i = 0; i < MAX_CONSTS; ++i) {
      memcpy(&e.c[i], q + 9 + MAX_TERMS + i, sizeof(double));
    }
    if (!family_ok(e.family, e.J) || q[8] <= 0 || q[8] >= (1LL << 30) ||
        e.lanes < 1 || e.lanes > THREADS || e.y == nullptr ||
        e.m == nullptr || e.v == nullptr || e.mask == nullptr ||
        e.scale == nullptr || e.val == nullptr || e.sum == nullptr ||
        (deriv && e.coef == nullptr)) {
      return -1;
    }
    if (has_sweep(e.family)) {
      if (e.S <= 0 || e.nodes == nullptr || e.w == nullptr) return -1;
      const int count = terms_of(e.family, e.J);
      if (count > 0) {  // the terms' node counts make up the table
        long long total = 0;
        for (int k = 0; k < MAX_TERMS; ++k) {
          if ((k < count) != (e.sizes[k] > 0)) return -1;
          total += e.sizes[k];
        }
        if (total != e.S) return -1;
        terms = true;
      }
    } else {
      e.lanes = 1;  // one thread a row
    }
    if (e.family == 1) widest = e.J > widest ? e.J : widest;
    e.N = (int)q[8];
    e.rows = THREADS / e.lanes;
    e.first_block = (int)blocks;
    e.blocks = (e.N + e.rows - 1) / e.rows;
    blocks += e.blocks;
    if (blocks > 0x7fffffffLL) return -1;
  }
  return blocks;
}

template <typename T>
int launch(const void* const* ptrs, const long long* ints, int tasks,
           int deriv, void* partials, long long partial_count,
           cudaStream_t stream) {
  Table table;
  int widest;
  bool terms;
  const long long blocks =
      plan(ptrs, ints, tasks, deriv != 0, table, widest, terms);
  if (blocks <= 0 || partials == nullptr || partial_count < blocks) {
    return (int)cudaErrorInvalidValue;
  }
  table.partials = partials;
  const dim3 grid((unsigned)blocks), block(THREADS);
  // a table holding a multi-term family takes the instantiations that
  // compile them in, any other the ones it took before they were
  if (terms && !deriv) {
    ve_tasks_kernel<T, false, 4, true><<<grid, block, 0, stream>>>(table);
  } else if (terms) {
    ve_tasks_kernel<T, true, 16, true><<<grid, block, 0, stream>>>(table);
  } else if (!deriv) {
    ve_tasks_kernel<T, false, 1, false><<<grid, block, 0, stream>>>(table);
  } else if (widest <= 2) {
    ve_tasks_kernel<T, true, 5, false><<<grid, block, 0, stream>>>(table);
  } else {
    ve_tasks_kernel<T, true, 11, false><<<grid, block, 0, stream>>>(table);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grad(const void* const* ptrs, const long long* ints, int tasks,
                cudaStream_t stream) {
  if (tasks <= 0 || tasks > MAX_TASKS) return (int)cudaErrorInvalidValue;
  GradTable table;
  table.count = tasks;
  long long blocks = 0;
  for (int t = 0; t < tasks; ++t) {
    const void* const* p = ptrs + GRAD_PTRS * t;
    const long long* q = ints + GRAD_INTS * t;
    GradTask& e = table.task[t];
    e.coef = p[0]; e.mask = p[1]; e.scale = p[2]; e.g = p[3];
    e.dm = const_cast<void*>(p[4]);
    e.dv = const_cast<void*>(p[5]);
    e.smask = q[0]; e.J = (int)q[1];
    for (int k = 0; k < GRAD_PTRS; ++k) {
      if (p[k] == nullptr) return (int)cudaErrorInvalidValue;
    }
    if (e.J < 1 || e.J > 5 || q[2] <= 0 || q[2] >= (1LL << 30)) {
      return (int)cudaErrorInvalidValue;
    }
    e.N = (int)q[2];
    e.first_block = (int)blocks;
    blocks += (e.N + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  ve_tasks_grad_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(table);
  return (int)cudaGetLastError();
}

}  // namespace

// How many tasks one launch takes (the wrapper splits a longer table), and
// the blocks a table's launch has (its partials: one a block), or -1 for a
// table the kernel does not take.  ptrs: PTRS pointers a task (y, m, v,
// mask, scale, nodes, w, val, coef or null for the value alone, sum);
// ints: INTS integers a task (the row strides of y, m, v and mask, the
// family code, J, lanes a row, nodes S, rows N, then MAX_TERMS node counts
// of a multi-term family's terms, in its order, 0 past its last, and
// MAX_CONSTS constants as the bits of float64).
extern "C" int hetmogp_ve_tasks_max() { return MAX_TASKS; }

extern "C" long long hetmogp_ve_tasks_blocks(const void* const* ptrs,
                                             const long long* ints, int tasks,
                                             int deriv) {
  Table table;
  int widest;
  bool terms;
  return plan(ptrs, ints, tasks, deriv != 0, table, widest, terms);
}

extern "C" int hetmogp_ve_tasks_f32(const void* const* ptrs,
                                    const long long* ints, int tasks,
                                    int deriv, void* partials,
                                    long long partial_count,
                                    cudaStream_t stream) {
  return launch<float>(ptrs, ints, tasks, deriv, partials, partial_count,
                       stream);
}

extern "C" int hetmogp_ve_tasks_f64(const void* const* ptrs,
                                    const long long* ints, int tasks,
                                    int deriv, void* partials,
                                    long long partial_count,
                                    cudaStream_t stream) {
  return launch<double>(ptrs, ints, tasks, deriv, partials, partial_count,
                        stream);
}

// The backward launch: GRAD_PTRS pointers a task (coef, mask, scale, g,
// dm, dv; dm and dv (N, J) contiguous), GRAD_INTS integers (the mask's row
// stride, J, N).
extern "C" int hetmogp_ve_tasks_grad_f32(const void* const* ptrs,
                                         const long long* ints, int tasks,
                                         cudaStream_t stream) {
  return launch_grad<float>(ptrs, ints, tasks, stream);
}

extern "C" int hetmogp_ve_tasks_grad_f64(const void* const* ptrs,
                                         const long long* ints, int tasks,
                                         cudaStream_t stream) {
  return launch_grad<double>(ptrs, ints, tasks, stream);
}
