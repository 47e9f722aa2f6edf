// Kernel 9: the Cholesky factor of one small SPD panel and the factor's
// inverse, on Hopper (sm_90a), float32 and float64.
//
// For each (n, n) matrix A of the batch (n <= 128; only its lower triangle
// is read): L = chol(A), lower-triangular, and iL = L^{-1}, both written
// with exact zeros above the diagonal.  A pivot that is not positive (or is
// NaN) fills that matrix's L on and below the diagonal, and all of its iL,
// with NaN (what jnp.linalg.cholesky and solve_triangular give the JAX
// package); nothing is read on the host, so the launch sits inside a
// captured CUDA graph.
//
// Replaces no Pallas kernel: it is the serial step of the JAX package's
// blocked factorization, hetmogp_tpu/ops/linalg.py::_blocked_cholesky_panels
// (:411-413), which factors each (nb, nb) diagonal panel with
// jnp.linalg.cholesky and inverts it with solve_triangular against I, XLA's
// serial routines.  ops/linalg.py::blocked_cholesky_inverse runs the rest of
// that algorithm (the panels' updates and the inverse's row strips) as
// products on cuBLAS and kernels A and 4.
//
// What bounds it on an H100: neither bytes nor operations.  At (4, 128, 128)
// the work is 2 * 4 * 128^3 / 3 = 5.6 MFLOP and 0.66 MB, both far under an
// empty launch.  The limit is the serial chain of n pivots, each needing the
// last, on the one SM that holds the matrix (one block a matrix), and then
// the SM's shared-memory pipe: every FMA of a substitution or a rank-1
// update takes a value that all lanes share, and a broadcast costs a
// wavefront a value whatever the width of the load.  So the design takes
// everything that is not that chain off it, and keeps the chain's other
// part alone on the pipe.  The panel is cut into sub-panels of SUB columns
// (32, a warp's lanes: sub-panels of 16 were slower, probe run P11) and
// the block into two roles:
//   * the pivot warp (warp 0) runs only the chain: for each sub-panel s it
//     waits until the diagonal block s has every update (READY[s]), factors
//     it in registers and publishes it (FACT[s]).  Lane i keeps a window of
//     row i that moves one column a pivot, so the loop stays rolled (32
//     pivots unrolled stream their code through the instruction cache on
//     every sub-panel: 9 us for one pivot, probe run P1); each pivot
//     reaches the lanes by one shuffle of the next lane's own updated
//     diagonal, so the root of pivot j + 1 overlaps the publishing of
//     column j;
//   * the update warps (warps 1-7) do the rest, with look-ahead: once
//     sub-panel s is factored, warp 1 alone solves the next block's rows,
//     L21 = A21 L11^{-T}, by substitution (a product with the inverse would
//     lose cond(L11) eps), a lane a row; all subtract L21 L21^T from the
//     next diagonal block and release it (READY[s + 1]).  Only then, while
//     the pivot warp factors s + 1, do they solve the other rows below,
//     form iL's block row s by substitution against [-X_s | I], where X_s
//     = L[s, :s] iL[:s, :s] (so the diagonal block's inverse D_s is formed
//     here, off the chain), store the finished block column of L and block
//     row of iL, subtract the rest of the trailing update, and add block
//     row s's share to every later X.
// What is left on the chain per sub-panel: one factor, one SUB-row
// substitution and one SUB x SUB x SUB update; after the last pivot, the
// substitution of iL's last block row and its store.
//
// Synchronisation is by role, never the whole block between phases:
// mbarriers in shared memory (LOAD[I] a block row of A arrived, FACT[s],
// READY[s]; each used for one phase a launch) and one named barrier among
// the update warps.  Every arrive comes after the arriving thread's own
// stores of what the waiter reads, and every sub-panel's factored columns
// keep their own buffer, since the update warps still read block s's
// while the pivot warp publishes block s + 1's.  A is loaded with
// per-element asynchronous copies (cp.async, completing on LOAD[I], so the
// pivot warp starts on block row 0 while the rest streams in): the panel's
// rows sit at odd strides in shared memory (a column read by 32 lanes then
// hits 32 banks, on the chain), which bulk copies, 16-byte aligned, cannot
// address.  Shared memory is sized to the launch's n: the panel and iL in
// block rows that stop at their diagonal block, the solved rows below the
// current sub-panel, transposed (LT), and the factored columns, each from
// its diagonal on (16-byte rows, read as vectors).  Every sum runs in a
// fixed order (no atomics), so two launches are bitwise equal.  No tensor
// cores: TF32 is banned on this path and three bf16 passes are not
// accurate enough for a pivot chain at cond ~1e6.
//
// A probe build (nvcc -DK9_STAMPS; probes/chol_panel.py) stamps clock64()
// by role and phase into `stamps` (hetmogp_chol_panel_stamps); the shipped
// build compiles no stamp.
//
// The panel routine is factor_panel, one call a panel, which kernel 10
// (chol_blocked_kernel.cu) also calls on each diagonal tile of its
// persistent blocks: it includes this file with CHOL_PANEL_DEVICE_ONLY
// defined, which leaves out the launcher and the C entries.  A block's
// mbarriers are initialised at its first call and then used once a call,
// so call c waits on phase parity c & 1; A may be L itself (every element
// of A is in shared memory before the first store).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace chol_panel {

constexpr int THREADS = 256;
constexpr int UPDATERS = THREADS - 32;  // warps 1-7
constexpr int NMAX = 128;               // the widest panel
constexpr int SUB = 32;                 // a sub-panel's columns
constexpr int MAX_SUBS = NMAX / SUB;
constexpr int UPDATE_BAR = 1;  // the update warps' named barrier

constexpr unsigned FULL = 0xffffffffu;

// ---- device primitives (tests/host_cuda/cuda_runtime.h supplies each of
// them for the host build of this source) -------------------------------------
#ifdef __CUDACC__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that cannot
// end traps, so a fault shows as a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// One element from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async have landed
// (.noinc: the barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
#endif

// sqrt(p) and 1/sqrt(p).  Float32: the hardware's reciprocal square root,
// then one fused correction of d and one of r = 1/d, with no branch on the
// chain (the IEEE sqrtf and divide cost ~130 cycles a pivot, 0.0488 ms
// against 0.0469 at (4, 128, 128); the blocked pair's errors are theirs,
// and rsqrtf alone left L's 1.3x potrf's: probe runs P12, P13).  Float64
// correctly rounded.
__device__ __forceinline__ void inv_root(float p, float& d, float& r) {
  r = rsqrtf(p);
  d = p * r;
  d = fmaf(fmaf(-d, d, p), 0.5f * r, d);
  r = fmaf(r, fmaf(-d, r, 1.0f), r);
}
__device__ __forceinline__ void inv_root(double p, double& d, double& r) {
  d = sqrt(p);
  r = 1.0 / d;
}

// ---- shared-memory layout, sized to n ----------------------------------------
//
// Row r of block row I = r / SUB holds columns [0, rowlen(r)), through its
// diagonal block.  The panel P (A, then L in place) strides rowlen + 1
// (odd: a column read by a warp is conflict-free); iL (and the X_s
// accumulating in its block rows) strides rowlen rounded up to 16 bytes;
// LT holds the SUB solved columns of the rows below the current sub-panel,
// transposed, LTLD = n - SUB rounded up to 4 apart; TB each sub-panel's
// factored columns from their diagonal on (SUB x SUB a sub-panel).

__host__ __device__ __forceinline__ int rowlen(int r, int n) {
  const int end = (r / SUB + 1) * SUB;
  return end < n ? end : n;
}
__host__ __device__ __forceinline__ int poff(int r, int n) {
  const int I = r / SUB;
  return SUB * SUB * I * (I + 1) / 2 + SUB * I + (r - I * SUB) *
                                                     (rowlen(r, n) + 1);
}
template <typename T>
__host__ __device__ __forceinline__ int round_vec(int x) {
  constexpr int v = 16 / (int)sizeof(T);
  return (x + v - 1) / v * v;
}
template <typename T>
__host__ __device__ __forceinline__ int ioff(int r, int n) {
  const int I = r / SUB;
  return SUB * SUB * I * (I + 1) / 2 + (r - I * SUB) *
                                           round_vec<T>(rowlen(r, n));
}
__host__ __device__ __forceinline__ int ltld(int n) {
  const int rows = n > SUB ? n - SUB : 0;
  return (rows + 3) / 4 * 4;
}
template <typename T>
__host__ __device__ __forceinline__ int smem_elems(int n) {
  return round_vec<T>(poff(n, n)) + ioff<T>(n, n) + SUB * ltld(n) +
         (n + SUB - 1) / SUB * SUB * SUB;
}
template <typename T>
int smem_bytes(int n) {
  return smem_elems<T>(n) * (int)sizeof(T);
}

template <typename T>
struct Panel {
  T* P;
  T* iL;
  T* LT;
  T* TB;  // each sub-panel's factored columns, tb[j * SUB + m] = L[j + m][j]
  int n, ld_t;
  __device__ __forceinline__ T* prow(int r) const { return P + poff(r, n); }
  __device__ __forceinline__ T* irow(int r) const {
    return iL + ioff<T>(r, n);
  }
};

template <typename T>
__device__ __forceinline__ unsigned char* shared_panel() {
  extern __shared__ __align__(16) unsigned char chol_panel_smem[];
  return chol_panel_smem;
}

// ---- probe stamps --------------------------------------------------------------

namespace k9s {
enum Stamp {
  BLOCK,          // the pivot warp's lane 0, kernel start to end, cycles
  START_NS,       // %globaltimer there at the start
  END_NS,         // and at the end
  P_LOAD_WAIT,    // the pivot warp waiting for block row 0 of A
  P_READY_WAIT,   // waiting for a diagonal block's updates (sum)
  P_FACTOR,       // factoring (sum)
  U_FACT_WAIT,    // the first update thread (a row of the next block):
                  // waiting for a factored block (from A's load on)
  U_SOLVE,        // solving its row of the next block, and the barrier
  U_LOOKAHEAD,    // the next diagonal block's update and READY
  U_SOLVE_REST,   // the other rows and iL's block row, and the barrier
  U_STORE,        // storing L's block column and iL's block row
  U_TILES,        // the rest of the trailing update
  U_XPROD,        // the X shares of iL's block row, and the barrier
  U_INVERSE,      // the first thread on iL's block row, its columns
  EPILOGUE,       // the whole block's last barrier and the NaN check
  FACTOR_0 = 20,                     // each sub-panel's factor, cycles
  READY_AT_0 = FACTOR_0 + MAX_SUBS,   // the pivot warp past READY[s], since
                                      // start
  FACT_AT_0 = READY_AT_0 + MAX_SUBS,  // and FACT[s] arrived, since start
  N_STAMPS = FACT_AT_0 + MAX_SUBS
};
#ifdef K9_STAMPS
constexpr int MAX_BLOCKS = 64;
__device__ long long stamps[MAX_BLOCKS * N_STAMPS];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void put(int k, long long v) {
  if (blockIdx.x < MAX_BLOCKS) stamps[blockIdx.x * N_STAMPS + k] = v;
}
#endif
}  // namespace k9s

#ifdef K9_STAMPS
#define K9_STAMP(...) __VA_ARGS__
#else
#define K9_STAMP(...)
#endif

// R consecutive elements of shared memory, as 16-byte vectors where R
// allows: the column windows and the tiles' rows are aligned so.
template <int R, typename T>
__device__ __forceinline__ void load_run(const T* p, T (&v)[R]) {
#ifdef __CUDACC__
  if constexpr (R * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int k = 0; k < R; k += 16 / (int)sizeof(T)) {
      if constexpr (sizeof(T) == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + k);
        v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
      } else {
        const double2 q = *reinterpret_cast<const double2*>(p + k);
        v[k] = q.x, v[k + 1] = q.y;
      }
    }
    return;
  }
#endif
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = p[k];
}

// ---- the pivot warp ------------------------------------------------------------

// Factor the (w, w) diagonal block at blk (row stride ld) in place, lane
// i < w holding row i.  Each lane keeps a window of its row in registers,
// a[m] = column j + m, that moves one column a pivot: the update of column
// j writes each entry into the slot it takes for column j + 1, so no
// register is picked by a run-time index and the loop stays rolled (a
// loop unrolled over 32 pivots streams its code through the instruction
// cache on every sub-panel).  Column j is published to tb from its
// diagonal on and read back whole, as vectors (a scalar shared load for
// each FMA would make the warps' shared-memory pipe the limit).  The next
// pivot, lane j + 1's own diagonal less the square of its L[j + 1][j], is
// shuffled to every lane before column j is published, so its root
// overlaps the publishing and the update.  rd[j] = 1 / L[j][j].  Entries
// right of a lane's diagonal hold whatever they hold and are never read.
template <typename T>
__device__ __forceinline__ void factor_block(T* blk, int ld, int w, T* tb,
                                             T* rd, int lane, bool& bad) {
  const bool mine = lane < w;
  T* row = blk + (mine ? lane : 0) * ld;
  T a[SUB];
#pragma unroll
  for (int k = 0; k < SUB; ++k) a[k] = mine && k <= lane ? row[k] : T(0);
  T d, r;
  {
    const T p = __shfl_sync(FULL, a[0], 0);
    bad |= !(p > T(0));
    inv_root(p, d, r);
  }
#pragma unroll 1
  for (int j = 0; j < w; ++j) {
    const T aj = lane == j ? d : a[0] * r;  // L[lane][j]
    if (lane == j) rd[j] = r;
    T dn = T(0), rn = T(0);
    if (j + 1 < w) {
      const T pn = __shfl_sync(FULL, a[1] - aj * aj, j + 1);
      bad |= !(pn > T(0));
      inv_root(pn, dn, rn);
    }
    if (mine && lane >= j) {
      row[j] = aj;
      tb[j * SUB + lane - j] = aj;
    }
    __syncwarp();
    T col[SUB];  // L[j + m][j]
    load_run<SUB>(tb + j * SUB, col);
#pragma unroll
    for (int m = 1; m < SUB; ++m) a[m - 1] = a[m] - aj * col[m];
    a[SUB - 1] = T(0);
    d = dn;
    r = rn;
  }
}

// ---- the update warps ----------------------------------------------------------

// x <- L^{-1} x by the factored (w, w) block whose columns are in tb, rd
// its reciprocal diagonal: x is a window, x[m] = row j + m, moving one row
// a step as in factor_block; out(j, value) takes each row's result.  The
// block is factored before any solve starts, so each step loads the next
// step's column while it works on its own (unrolled by two, so that the
// two columns trade registers by name).
template <typename T, typename Out>
__device__ __forceinline__ void solve_block(T (&x)[SUB], const T* tb,
                                            const T* rd, int w, Out out) {
  T col[SUB];
  load_run<SUB>(tb, col);
  T r = rd[0];
#pragma unroll 2
  for (int j = 0; j < w; ++j) {
    const int jn = j + 1 < w ? j + 1 : j;
    T next[SUB];
    load_run<SUB>(tb + jn * SUB, next);
    const T rn = rd[jn];
    const T xj = x[0] * r;
    out(j, xj);
#pragma unroll
    for (int m = 1; m < SUB; ++m) x[m - 1] = x[m] - xj * col[m];
    x[SUB - 1] = T(0);
#pragma unroll
    for (int m = 0; m < SUB; ++m) col[m] = next[m];
    r = rn;
  }
}

// The (ti, tc) of lower-triangular tile t, tc <= ti: t = ti (ti + 1) / 2 + tc.
__device__ __forceinline__ void tri_tile(int t, int& ti, int& tc) {
  ti = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  tc = t - ti * (ti + 1) / 2;
}

// Trailing tile t of R x R over the `rows` rows below sub-panel s (from row
// t0 on): P[i][c] -= sum_j LT[j][i] LT[j][c] on and below the diagonal.
template <int R, typename T>
__device__ __forceinline__ void trailing_tile(const Panel<T>& pn, int t,
                                              int t0, int rows, int w) {
  int ti, tc;
  tri_tile(t, ti, tc);
  const int i = R * ti, c = R * tc;
  T acc[R][R];
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int y = 0; y < R; ++y) acc[x][y] = T(0);
#pragma unroll 4
  for (int j = 0; j < w; ++j) {
    const T* lt = pn.LT + j * pn.ld_t;
    T a[R], b[R];
    load_run<R>(lt + i, a);
    load_run<R>(lt + c, b);
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int y = 0; y < R; ++y) acc[x][y] += a[x] * b[y];
  }
#pragma unroll
  for (int x = 0; x < R; ++x) {
    if (i + x < rows) {
      T* out = pn.prow(t0 + i + x) + t0 + c;
#pragma unroll
      for (int y = 0; y < R; ++y) {
        if (c + y <= i + x) out[y] -= acc[x][y];
      }
    }
  }
}

// Row t0 + i of the rows below sub-panel s (from k0, w wide) solved in
// place, L21 = A21 L11^{-T}, and transposed into LT's column i.
template <typename T>
__device__ __forceinline__ void solve_row(const Panel<T>& pn, const T* tbs,
                                          const T* rd, int k0, int w, int t0,
                                          int i) {
  T* arow = pn.prow(t0 + i) + k0;
  T* lt = pn.LT + i;
  T x[SUB];
#pragma unroll
  for (int k = 0; k < SUB; ++k) x[k] = k < w ? arow[k] : T(0);
  solve_block(x, tbs, rd, w, [&](int j, T v) {
    arow[j] = v;
    lt[j * pn.ld_t] = v;
  });
}

// The panel A (n x n, row stride a_r) of the calling block: L and iL
// written through their row strides.  `call` counts the block's earlier
// calls (0 in kernel 9); every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void factor_panel(const T* A, long long a_r, T* L,
                                             long long l_r, T* iL,
                                             long long i_r, int n,
                                             int call) {
  __shared__ uint64_t bars[3 * MAX_SUBS];  // LOAD, FACT, READY
  __shared__ T rdiag[NMAX];                // 1 / L[j][j]
  __shared__ int failed;
  const uint32_t parity = (uint32_t)call & 1u;
  K9_STAMP(__shared__ long long inverse_cycles[MAX_SUBS];)
  uint64_t* const LOAD = bars;
  uint64_t* const FACT = bars + MAX_SUBS;
  uint64_t* const READY = bars + 2 * MAX_SUBS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int subs = (n + SUB - 1) / SUB;
  Panel<T> pn;
  {
    T* base = reinterpret_cast<T*>(shared_panel<T>());
    pn.P = base;
    pn.iL = base + round_vec<T>(poff(n, n));
    pn.LT = pn.iL + ioff<T>(n, n);
    pn.TB = pn.LT + SUB * ltld(n);
    pn.n = n;
    pn.ld_t = ltld(n);
  }
  K9_STAMP(long long k9[k9s::N_STAMPS] = {}; long long k9_t0 = clock64();
           long long k9_t = k9_t0;
           if (tid == 0) k9s::put(k9s::START_NS, k9s::global_ns());)
  if (tid == 0) {
    if (call == 0) {
      for (int s = 0; s < subs; ++s) {
        mbar_init(LOAD + s, UPDATERS);
        mbar_init(FACT + s, 32);
        mbar_init(READY + s, UPDATERS);
      }
    }
    failed = 0;
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- the pivot warp: the chain alone
    bool bad = false;
    for (int s = 0; s < subs; ++s) {
      const int k0 = s * SUB, w = min(SUB, n - k0);
      K9_STAMP(k9_t = clock64();)
      mbar_wait(s == 0 ? LOAD : READY + s, parity);
      K9_STAMP(const long long k9_r = clock64();
               k9[s == 0 ? k9s::P_LOAD_WAIT : k9s::P_READY_WAIT] +=
               k9_r - k9_t;
               k9[k9s::READY_AT_0 + s] = k9_r - k9_t0;)
      factor_block(pn.prow(k0) + k0, rowlen(k0, n) + 1, w,
                   pn.TB + s * SUB * SUB, rdiag + k0, lane, bad);
      __syncwarp();
      mbar_arrive(FACT + s);
      K9_STAMP(const long long k9_f = clock64();
               k9[k9s::P_FACTOR] += k9_f - k9_r;
               k9[k9s::FACTOR_0 + s] = k9_f - k9_r;
               k9[k9s::FACT_AT_0 + s] = k9_f - k9_t0;)
    }
    if (lane == 0 && bad) failed = 1;
  } else {
    // A's lower triangle, a warp a row and a lane a column, one barrier a
    // block row of SUB rows
    for (int s = 0; s < subs; ++s) {
      const int r1 = min(n, (s + 1) * SUB);
      for (int r = s * SUB + warp - 1; r < r1; r += 7) {
        T* dst = pn.prow(r);
        for (int c = lane; c <= r; c += 32) {
          cp_async_elem(dst + c, A + r * a_r + c);
        }
      }
      cp_async_arrive(LOAD + s);
    }
    for (int s = 0; s < subs; ++s) mbar_wait(LOAD + s, parity);
  }

  if (warp > 0) {
    // ---- the update warps: the rest
    const int tu = tid - 32;
    K9_STAMP(k9_t = clock64();)
    for (int s = 0; s < subs; ++s) {
      const int k0 = s * SUB, w = min(SUB, n - k0);
      const int t0 = k0 + w, rows = n - t0, cols = t0;
      const T* rd = rdiag + k0;
      const T* tbs = pn.TB + s * SUB * SUB;
      mbar_wait(FACT + s, parity);
      K9_STAMP(k9[k9s::U_FACT_WAIT] += clock64() - k9_t; k9_t = clock64();)
      // the chain's part: the next block's rows, L21 = A21 L11^{-T}, by
      // substitution, a lane a row (in place, and transposed into LT),
      // alone on the shared-memory pipe; then the next diagonal block's
      // update (look-ahead) and its release
      const int r1 = min(rows, SUB);
      if (tu < r1) solve_row(pn, tbs, rd, k0, w, t0, tu);
      named_barrier_sync(UPDATE_BAR, UPDATERS);
      K9_STAMP(k9[k9s::U_SOLVE] += clock64() - k9_t; k9_t = clock64();)
      if (s + 1 < subs) {
        const int h = (r1 + 1) / 2;
        for (int t = tu; t < h * (h + 1) / 2; t += UPDATERS) {
          trailing_tile<2>(pn, t, t0, rows, w);
        }
        mbar_arrive(READY + s + 1);
      }
      K9_STAMP(k9[k9s::U_LOOKAHEAD] += clock64() - k9_t; k9_t = clock64();)

      // off the chain, while the pivot warp factors the next block: the
      // other rows below, a thread a row, and on the threads from e0 on,
      // iL's block row s by substitution against [-X_s | I], a column a
      // thread (an identity column starts with its zeros above the
      // diagonal, which the substitution keeps exact).  One right-hand
      // side a thread: more warps in flight beat fewer loads of tbs
      // (probe run P10)
      {
        const int e0 = (rows - r1 + 31) / 32 * 32;
        if (tu < rows - r1) {
          solve_row(pn, tbs, rd, k0, w, t0, r1 + tu);
        } else if (tu >= e0) {
          K9_STAMP(const long long k9_e = clock64();)
          T* xrow = pn.irow(k0);
          const int xld = round_vec<T>(rowlen(k0, n));
          for (int c = tu - e0; c < cols; c += UPDATERS - e0) {
            T x[SUB];
#pragma unroll
            for (int k = 0; k < SUB; ++k) {
              x[k] = c < k0 ? (k < w ? -xrow[k * xld + c] : T(0))
                            : (k == c - k0 ? T(1) : T(0));
            }
            solve_block(x, tbs, rd, w,
                        [&](int j, T v) { xrow[j * xld + c] = v; });
          }
          K9_STAMP(if (tu == e0) inverse_cycles[s] = clock64() - k9_e;)
        }
      }
      named_barrier_sync(UPDATE_BAR, UPDATERS);
      K9_STAMP(k9[k9s::U_SOLVE_REST] += clock64() - k9_t; k9_t = clock64();)

      // L's block column s and iL's block row s are final: store them,
      // zeros above the diagonal included; a warp a row, a block row of P
      // at a time (one stride each)
      if (lane < w) {
        T* dst = L + k0 + lane;
        for (int r = warp - 1; r < k0; r += UPDATERS / 32) dst[r * l_r] = T(0);
        for (int I = s; I < subs; ++I) {
          const int r0 = I * SUB, r1 = min(n, r0 + SUB);
          const T* src = pn.prow(r0) + k0 + lane;
          const int ld = rowlen(r0, n) + 1;
#pragma unroll 4
          for (int r = r0 + warp - 1; r < r1; r += UPDATERS / 32) {
            dst[r * l_r] = k0 + lane <= r ? src[(r - r0) * ld] : T(0);
          }
        }
      }
      {
        const T* src = pn.irow(k0);
        const int xld = round_vec<T>(rowlen(k0, n));
        for (int r = warp - 1; r < w; r += UPDATERS / 32) {
          T* dst = iL + (k0 + r) * i_r;
#pragma unroll 4
          for (int c = lane; c < n; c += 32) {
            dst[c] = c <= k0 + r ? src[r * xld + c] : T(0);
          }
        }
      }
      K9_STAMP(k9[k9s::U_STORE] += clock64() - k9_t; k9_t = clock64();)

      // the rest of the trailing update, in 4 x 4 tiles
      {
        const int h = (rows + 3) / 4, first = (SUB / 4) * (SUB / 4 + 1) / 2;
        for (int t = first + tu; t < h * (h + 1) / 2; t += UPDATERS) {
          trailing_tile<4>(pn, t, t0, rows, w);
        }
      }
      K9_STAMP(k9[k9s::U_TILES] += clock64() - k9_t; k9_t = clock64();)

      // block row s's share of every later X: X[t0 + m][c] (+)= sum_d
      // L[t0 + m][k0 + d] iL[k0 + d][c] over the sub-panel, c < cols (iL's
      // block row s is zero above its diagonal); a column's first share
      // sets it
      {
        const int mt = (rows + 3) / 4, ct = cols / 4;
        const T* irow0 = pn.irow(k0);
        const int ild = round_vec<T>(rowlen(k0, n));
        for (int t = tu; t < mt * ct; t += UPDATERS) {
          const int m = 4 * (t / ct), c = 4 * (t % ct);
          T acc[4][4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
          for (int d = c > k0 ? c - k0 : 0; d < w; ++d) {
            T a[4], v[4];
            load_run<4>(pn.LT + d * pn.ld_t + m, a);
            load_run<4>(irow0 + d * ild + c, v);
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int y = 0; y < 4; ++y) acc[x][y] += a[x] * v[y];
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (m + x < rows) {
              T* out = pn.irow(t0 + m + x) + c;
#pragma unroll
              for (int y = 0; y < 4; ++y) {
                out[y] = c >= k0 ? acc[x][y] : out[y] + acc[x][y];
              }
            }
          }
        }
      }
      named_barrier_sync(UPDATE_BAR, UPDATERS);
      K9_STAMP(k9[k9s::U_XPROD] += clock64() - k9_t; k9_t = clock64();)
    }
  }

  K9_STAMP(k9_t = clock64();)
  __syncthreads();
  if (failed) {
    const T nan = static_cast<T>(NAN);
    for (int e = tid; e < n * NMAX; e += THREADS) {
      const int r = e / NMAX, c = e % NMAX;
      if (c < n) {
        if (c <= r) L[r * l_r + c] = nan;
        iL[r * i_r + c] = nan;
      }
    }
  }
  K9_STAMP(
      if (tid == 32) {
        k9[k9s::EPILOGUE] = clock64() - k9_t;
        long long inv = 0;
        for (int s = 0; s < subs; ++s) inv += inverse_cycles[s];
        k9[k9s::U_INVERSE] = inv;
        for (int k = k9s::U_FACT_WAIT; k <= k9s::EPILOGUE; ++k)
          k9s::put(k, k9[k]);
      } if (tid == 0) {
        k9s::put(k9s::BLOCK, clock64() - k9_t0);
        k9s::put(k9s::END_NS, k9s::global_ns());
        for (int k = k9s::P_LOAD_WAIT; k <= k9s::P_FACTOR; ++k)
          k9s::put(k, k9[k]);
        for (int k = k9s::FACTOR_0; k < k9s::N_STAMPS; ++k) k9s::put(k, k9[k]);
      })
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chol_panel_kernel(const T* __restrict__ A, long long a_b, long long a_r,
                  T* __restrict__ L, long long l_b, long long l_r,
                  T* __restrict__ iL, long long i_b, long long i_r, int n) {
  const long long b = blockIdx.x;
  factor_panel(A + b * a_b, a_r, L + b * l_b, l_r, iL + b * i_b, i_r, n, 0);
}

#ifndef CHOL_PANEL_DEVICE_ONLY
template <typename T>
int launch(const T* A, long long a_b, long long a_r, T* L, long long l_b,
           long long l_r, T* iL, long long i_b, long long i_r, int batch,
           int n, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || n > NMAX || A == nullptr || L == nullptr ||
      iL == nullptr || a_r < n || l_r < n || i_r < n) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = smem_bytes<T>(n);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<T>(NMAX));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  chol_panel_kernel<T><<<batch, THREADS, bytes, stream>>>(
      A, a_b, a_r, L, l_b, l_r, iL, i_b, i_r, n);
  return (int)cudaGetLastError();
}

#endif  // CHOL_PANEL_DEVICE_ONLY

}  // namespace chol_panel

#ifndef CHOL_PANEL_DEVICE_ONLY
// A (batch, n, n) through a_b (batch stride) and a_r (row stride), in
// elements, its last stride 1; L and iL likewise.  Returns a CUDA error
// code, 0 on success.
extern "C" int hetmogp_chol_panel_f32(const float* A, long long a_b,
                                      long long a_r, float* L, long long l_b,
                                      long long l_r, float* iL, long long i_b,
                                      long long i_r, int batch, int n,
                                      cudaStream_t stream) {
  return chol_panel::launch(A, a_b, a_r, L, l_b, l_r, iL, i_b, i_r, batch, n,
                            stream);
}

extern "C" int hetmogp_chol_panel_f64(const double* A, long long a_b,
                                      long long a_r, double* L,
                                      long long l_b, long long l_r,
                                      double* iL, long long i_b,
                                      long long i_r, int batch, int n,
                                      cudaStream_t stream) {
  return chol_panel::launch(A, a_b, a_r, L, l_b, l_r, iL, i_b, i_r, batch, n,
                            stream);
}

// The dynamic shared memory a launch of width n asks for, in bytes
// (f64 != 0: the float64 instantiation).
extern "C" int hetmogp_chol_panel_smem(int f64, int n) {
  return f64 ? chol_panel::smem_bytes<double>(n)
             : chol_panel::smem_bytes<float>(n);
}

#ifdef K9_STAMPS
// The probe build's stamps of the last launch: `blocks` blocks of
// k9s::N_STAMPS into host memory.
extern "C" int hetmogp_chol_panel_stamps(void* out, int blocks) {
  if (blocks > chol_panel::k9s::MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(
      out, chol_panel::k9s::stamps,
      sizeof(long long) * blocks * chol_panel::k9s::N_STAMPS);
}
#endif
#endif  // CHOL_PANEL_DEVICE_ONLY
