// Kernel 10: the blocked Cholesky factor L and its inverse iL of a stack
// of SPD matrices in one launch, on Hopper (sm_90a), float32.
//
// For each (M, M) matrix of the batch (M = nt * TILE, TILE = 128: the
// wrapper pads a ragged M with an identity block and crops; only the lower
// triangle is read): L = chol(K) and iL = L^{-1}, lower-triangular with
// exact zeros above the diagonal.  A pivot that fails fills L's columns
// from its panel on (on and below the diagonal) and iL's rows from that
// panel on with NaN, as the chain of launches it replaces did; nothing is
// read on the host, so the launch sits inside a captured CUDA graph.
//
// Replaces no Pallas kernel: it is the JAX package's blocked factorization
// (hetmogp_tpu/ops/linalg.py::_blocked_cholesky_panels and
// _blocked_cholesky_inverse_single, :390-450), which ops/linalg.py ran as
// a chain of about a hundred dependent launches (kernel 9 on each
// diagonal panel, float64 cuBLAS updates, kernel A for the rows below and
// kernel 4 for the inverse's row strips), each on a few of the card's 132
// SMs: at (8, 1024, 1024) 1.5 ms, against 0.086 ms for its operations at
// 67 TFLOP/s.
//
// What bounds it on an H100: the chain of dependent tiles, not the work.
// Each diagonal tile needs the panel before it factored (kernel 9's
// routine: a pivot chain of 128 on one SM, ~0.043 ms) and the rows below
// solved and subtracted; nt of those in turn.  So the whole DAG runs in
// one persistent launch: a block an SM (two an SM were slower: each
// slowed the other's pivot chain and products), each taking tile
// tasks (chol_blocked_plan.cuh: POTRF, TRSM, UPD, ACC, INV) by an atomic
// ticket in a fixed order that takes the chain to the next diagonal tile
// a phase ahead of the trailing update, and the B matrices' tasks
// interleaved.  A task waits (its thread 0, acquire loads, with a short
// sleep) on per-tile counters in `flags`, which the wrapper zeroes, and
// publishes its own with a release add after the block's stores.  A block
// waits only on tasks of earlier tickets, which blocks already running
// hold, so the launch cannot deadlock, whatever the grid.  The inverse's
// tiles run under the factorization's later panels.
//
// The float32 products are FFMA from shared memory, a warp 16 columns
// and each lane a 4 or 8 square register tile; the float64 updates run
// on the FP64 tensor cores (mma.sync m8n8k4, twice the DFMA rate; DFMA
// was half of an update's time).  TF32 is banned on this path and three
// bf16 passes are not accurate enough at cond ~1e6.  Operands are staged
// by cp.async in stages of KC along the reduction, as many in flight as
// fit; a warp skips the stages its columns never reach against a
// triangular operand.  TRSM and UPD work in row parts
// (chol_blocked_plan.cuh), so that a tile row's chain runs on several
// blocks.
// TRSM is the chain's algebra: below = acc tril(iL_kk)^T, then once
// R = acc - below L_kk^T, L_ik = below + R tril(iL_kk)^T (the explicit
// inverse alone loses cond(L_kk) eps); `below` is kept in iL's tile (i, k)
// until ACC or INV first writes it.  The updates C_ik -= L_ij L_kj^T run
// in float64 from L's float32 values (kept in shared memory as doubles),
// in a float64 scratch, and are rounded to float32 once, by the last,
// into L's tile (i, k), which POTRF or TRSM then read and overwrite; TRSM
// also writes a float64 copy of each tile of L it finishes (exact), which
// the updates stage as it is (a conversion in shared memory took a sixth
// of an update's time).
// Every sum runs in an order fixed by its task, and no atomic enters the
// arithmetic, so two launches are bitwise equal, a replayed graph is
// bitwise the eager call, and a matrix of a stack is bitwise the same
// matrix factored alone.
//
// A probe build (nvcc -DK10_STAMPS; probes/chol_blocked.py) stamps each
// ticket's task, SM, and %globaltimer at its ticket, its start (every
// dependency met) and its end into `stamps` (hetmogp_chol_blocked_stamps);
// the shipped build compiles no stamp.

#define CHOL_PANEL_DEVICE_ONLY
#include "chol_panel_kernel.cu"
#undef CHOL_PANEL_DEVICE_ONLY

#include "chol_blocked_plan.cuh"

namespace chol_blocked {

using namespace chol_blocked_plan;

constexpr int THREADS = chol_panel::THREADS;  // kernel 9's block
constexpr int KC = 32;          // reduction depth of a stage
constexpr int WAIT_LIMIT = 1 << 22;

// ---- device primitives (tests/host_cuda/cuda_runtime.h supplies each of
// them for the host build of this source) -------------------------------------
#ifdef __CUDACC__
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void backoff() { __nanosleep(64); }

// 16 bytes from global to shared memory, asynchronously, through L2 alone
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   chol_panel::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b over one 8 x 8 x 4 tile, float64, on the tensor cores: lane l
// holds A[l / 4][l % 4], B[l % 4][l / 4] and D[l / 4][2 (l % 4) + {0, 1}]
__device__ __forceinline__ void dmma_884(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}
#endif

__device__ __forceinline__ float fused(float a, float b, float c) {
  return fmaf(a, b, c);
}

// ---- probe stamps --------------------------------------------------------------

namespace k10s {
constexpr int PER_TASK = 6;  // ticket ns, start ns, end ns, SM, kind, tile
constexpr long long MAX_TASKS = 1 << 16;
#ifdef K10_STAMPS
__device__ long long stamps[MAX_TASKS * PER_TASK];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int sm_id() {
  int s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#endif
}  // namespace k10s

#ifdef K10_STAMPS
#define K10_STAMP(...) __VA_ARGS__
#else
#define K10_STAMP(...)
#endif

struct Args {
  const float* K;       // (B, M, M) through k_b and k_r, last stride 1
  long long k_b, k_r;
  float* L;             // (B, M, M) contiguous
  float* iL;            // (B, M, M) contiguous
  double* L64;          // (B, M, M): L's tiles below the diagonal, exactly
  double* C;            // (B, nt (nt + 1) / 2, TILE, TILE): the updates
  int* flags;           // n_flags(B, nt) counters, zero on entry
  int batch, nt;
};

__device__ __forceinline__ long long dim(const Args& a) {
  return (long long)a.nt * TILE;
}
__device__ __forceinline__ float* l_tile(const Args& a, int b, int i, int k) {
  return a.L + (b * dim(a) + i * TILE) * dim(a) + k * TILE;
}
__device__ __forceinline__ float* il_tile(const Args& a, int b, int i,
                                          int k) {
  return a.iL + (b * dim(a) + i * TILE) * dim(a) + k * TILE;
}
__device__ __forceinline__ double* l64_tile(const Args& a, int b, int i,
                                            int k) {
  return a.L64 + (b * dim(a) + i * TILE) * dim(a) + k * TILE;
}
__device__ __forceinline__ const float* k_tile(const Args& a, int b, int i,
                                               int k) {
  return a.K + b * a.k_b + (long long)i * TILE * a.k_r + k * TILE;
}
__device__ __forceinline__ double* c_tile(const Args& a, int b, int i,
                                          int k) {
  const long long tri = (long long)a.nt * (a.nt + 1) / 2;
  return a.C + (b * tri + i * (i + 1) / 2 + k) * (long long)TILE * TILE;
}

// A lane's place in a tile: warp w holds the 16 columns of block cb(w),
// TN a lane (CG = 16 / TN lanes along them), its RG = 32 / CG row groups
// TM rows each: lane (g, h) = (lane / CG, lane % CG) holds rows g + RG x
// (x < TM; a stage's rows then fall in different banks) and columns
// 16 cb + TN h + y (y < TN) of the ROWS = RG TM rows of a pass.  Warps w
// and w + 4 issue on one sub-partition of the SM and take blocks w and
// 7 - w, so that against a triangular operand, where a block's work grows
// with its index, every sub-partition has as much.
template <int TM, int TN>
struct Frag {
  static constexpr int CG = 16 / TN, RG = 32 / CG, ROWS = RG * TM;
  int warp, g, h;
  __device__ __forceinline__ Frag() {
    const int tid = threadIdx.x;
    warp = tid / 32;
    g = (tid % 32) / CG;
    h = (tid % 32) % CG;
  }
  __device__ __forceinline__ int row(int x) const { return g + RG * x; }
  __device__ __forceinline__ int cb() const {
    return warp < 4 ? warp : 11 - warp;
  }
  __device__ __forceinline__ int col0() const { return 16 * cb() + TN * h; }
};

// How a warp may skip against a triangular B: NT_LOWER, B read as
// B[c][m] and zero for m > c (tril(L)^T); NN_LOWER, B read as B[m][c]
// and zero for m < c (a diagonal tile of iL).
enum Tri { FULL = 0, NT_LOWER = 1, NN_LOWER = 2 };

// A staged row of KC elements is LR apart (4 of padding: the rows that a
// warp's vector loads, or an mma fragment's eight, read fall in
// different banks); B's rows of 128 columns, LB apart (float alone).
constexpr int LR = KC + 4;
constexpr int LB = TILE + 4;

template <typename T, int TM, int TN>
__device__ __forceinline__ void zero(T (&acc)[TM][TN]) {
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TN; ++y) acc[x][y] = T(0);
}

// element e of a float4 (e a constant once unrolled)
__device__ __forceinline__ float part_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// KC columns m0 .. of A's ROWS rows ([r][m], lr apart) and of B: B_T, its
// 128 rows c ([c][m], lr apart); else its KC rows m ([m][c], LB apart):
// asynchronous 16-byte copies through L2 alone, one commit group.
template <typename T, int ROWS, bool B_T>
__device__ __forceinline__ void issue_stage(T* As, const T* A, long long lda,
                                            const T* B, long long ldb,
                                            int m0) {
  constexpr int V = 16 / (int)sizeof(T);  // elements a copy
  T* Bs = As + ROWS * LR;
  for (int e = threadIdx.x; e < ROWS * KC / V; e += THREADS) {
    const int r = e / (KC / V), q = e % (KC / V);
    cp_async16(As + r * LR + V * q, A + r * lda + m0 + V * q);
  }
  for (int e = threadIdx.x; e < TILE * KC / V; e += THREADS) {
    if (B_T) {
      const int c = e / (KC / V), q = e % (KC / V);
      cp_async16(Bs + c * LR + V * q, B + c * ldb + m0 + V * q);
    } else {
      const int m = e / (TILE / V), q = e % (TILE / V);
      cp_async16(Bs + m * LB + V * q, B + (m0 + m) * ldb + V * q);
    }
  }
  cp_async_commit();
}

template <typename T, int ROWS, bool B_T>
__host__ __device__ constexpr int stage_bytes() {
  return (ROWS * LR + (B_T ? TILE * LR : KC * LB)) * (int)sizeof(T);
}

// The shared memory every task may use: kernel 9's panel at TILE (its
// largest user, chol_panel::smem_bytes<float>(128)).
constexpr int SMEM_LIMIT = 111104;

// Stages in flight: as many of a product's TILE / KC as fit.
template <typename T, int ROWS, bool B_T>
__host__ __device__ constexpr int stages_in_flight() {
  return SMEM_LIMIT / stage_bytes<T, ROWS, B_T>() < TILE / KC
             ? SMEM_LIMIT / stage_bytes<T, ROWS, B_T>()
             : TILE / KC;
}

// wait until at most n of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) {
    cp_async_wait<0>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else if (n == 2) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<3>();
  }
}

// acc[x][y] (+ or -)= sum over m of A[row(x)][m] B(m, col0 + y), m
// ascending, in float32; B(m, c) = B_T ? B[c][m] : B[m][c].  A's and B's
// rows are ld apart (floats, 16-byte aligned); A's pointer is at the
// pass's first row.  Stages of KC columns in flight (cp.async; as many as
// fit), so the next ones load while this one is multiplied.  A warp skips
// the stages its columns never reach against a triangular B.  Every
// thread of the block calls it; it ends at a barrier.
template <int TM, int TN, bool B_T, int TRI, bool SUBTRACT>
__device__ __forceinline__ void product(float (&acc)[TM][TN], const float* A,
                                        long long lda, const float* B,
                                        long long ldb, unsigned char* smem) {
  using T = float;
  using F = Frag<TM, TN>;
  constexpr int ROWS = F::ROWS;
  constexpr int STAGE = stage_bytes<T, ROWS, B_T>() / (int)sizeof(T);
  constexpr int NST = stages_in_flight<T, ROWS, B_T>();
  static_assert(NST >= 2, "two stages fit");
  T* stages = reinterpret_cast<T*>(smem);
  const F me;
  const int c0 = me.col0();
  int lo = 0, hi = TILE;  // the warp's reduction range
  if (TRI == NT_LOWER) hi = 16 * me.cb() + 16;
  if (TRI == NN_LOWER) lo = 16 * me.cb();
  constexpr int CHUNKS = TILE / KC;
  for (int ch = 0; ch < NST; ++ch) {
    issue_stage<float, ROWS, B_T>(stages + ch * STAGE, A, lda, B, ldb,
                                  ch * KC);
  }
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const int m0 = ch * KC;
    // the chunks after this one already issued
    cp_async_wait_pending((ch + NST < CHUNKS ? ch + NST : CHUNKS) - 1 - ch);
    __syncthreads();
    const T* As = stages + (ch % NST) * STAGE;
    const T* Bs = As + ROWS * LR;
    const int m_lo = lo > m0 ? lo - m0 : 0;
    const int m_hi = hi < m0 + KC ? (hi > m0 ? hi - m0 : 0) : KC;
    {
#pragma unroll 1
      for (int m = m_lo; m < m_hi; m += 4) {
        float4 a[TM];
#pragma unroll
        for (int x = 0; x < TM; ++x) {
          a[x] = *reinterpret_cast<const float4*>(As + me.row(x) * LR + m);
        }
        if constexpr (B_T) {
          float4 b[TN];
#pragma unroll
          for (int y = 0; y < TN; ++y) {
            b[y] = *reinterpret_cast<const float4*>(Bs + (c0 + y) * LR + m);
          }
#pragma unroll
          for (int x = 0; x < TM; ++x)
#pragma unroll
            for (int y = 0; y < TN; ++y) {
              const float s = SUBTRACT ? -1.0f : 1.0f;
              T v = acc[x][y];
              v = fused(s * a[x].x, b[y].x, v);
              v = fused(s * a[x].y, b[y].y, v);
              v = fused(s * a[x].z, b[y].z, v);
              v = fused(s * a[x].w, b[y].w, v);
              acc[x][y] = v;
            }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float b[TN];
            chol_panel::load_run<TN>(Bs + (m + e) * LB + c0, b);
#pragma unroll
            for (int x = 0; x < TM; ++x) {
              const float av =
                  SUBTRACT ? -part_of(a[x], e) : part_of(a[x], e);
#pragma unroll
              for (int y = 0; y < TN; ++y) {
                acc[x][y] = fused(av, b[y], acc[x][y]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (ch + NST < CHUNKS) {
      issue_stage<float, ROWS, B_T>(stages + (ch % NST) * STAGE, A, lda, B, ldb,
                                m0 + NST * KC);
    }
  }
}

template <int ROWS, bool B_T>
__host__ __device__ constexpr int product_smem() {
  return stages_in_flight<float, ROWS, B_T>() *
         stage_bytes<float, ROWS, B_T>();
}

// ---- the float64 updates on the FP64 tensor cores ---------------------------
//
// A pass of RT row tiles of 8 rows: warp w holds the 16 columns of block
// cb(w) (as Frag), in RT x 2 tiles of 8 x 8 (mma.sync m8n8k4, the FP64
// tensor cores, twice the DFMA rate); lane l holds, of tile (x, y), row
// 8 x + l / 4 and the columns 16 cb + 8 y + 2 (l % 4) and the next.
template <int RT>
struct MmaFrag {
  static constexpr int ROWS = 8 * RT;
  int warp, lane;
  __device__ __forceinline__ MmaFrag() {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
  }
  __device__ __forceinline__ int cb() const {
    return warp < 4 ? warp : 11 - warp;
  }
  __device__ __forceinline__ int row(int x) const { return 8 * x + lane / 4; }
  __device__ __forceinline__ int col(int y) const {
    return 16 * cb() + 8 * y + 2 * (lane % 4);
  }
};

template <int RT>
__host__ __device__ constexpr int mma_smem() {
  return stages_in_flight<double, 8 * RT, true>() *
         stage_bytes<double, 8 * RT, true>();
}

// acc[x][y] -= A[rows of tile x][m] B[columns of tile y][m] summed over m
// in steps of 4 (the mma's k), in float64: A's and B's rows are ld apart
// (L's float64 copies), A's pointer at the pass's first row.  Staged as
// the float32 products are; a fragment's 8 rows, LR apart, fall in
// different banks.  A warp that is not `active` stages its share and
// multiplies nothing.  Every thread of the block calls it; it ends at a
// barrier.
template <int RT>
__device__ __forceinline__ void mma_update(double (&acc)[RT][2][2],
                                           const double* A, long long lda,
                                           const double* B, long long ldb,
                                           unsigned char* smem, bool active) {
  using F = MmaFrag<RT>;
  constexpr int ROWS = F::ROWS;
  constexpr int STAGE = stage_bytes<double, ROWS, true>() / 8;
  constexpr int NST = stages_in_flight<double, ROWS, true>();
  static_assert(NST >= 2, "two stages fit");
  double* stages = reinterpret_cast<double*>(smem);
  const F me;
  const int k = me.lane % 4;
  constexpr int CHUNKS = TILE / KC;
  for (int ch = 0; ch < NST; ++ch) {
    issue_stage<double, ROWS, true>(stages + ch * STAGE, A, lda, B, ldb,
                                    ch * KC);
  }
  for (int ch = 0; ch < CHUNKS; ++ch) {
    cp_async_wait_pending((ch + NST < CHUNKS ? ch + NST : CHUNKS) - 1 - ch);
    __syncthreads();
    const double* As = stages + (ch % NST) * STAGE;
    const double* Bs = As + ROWS * LR;
    if (active) {
#pragma unroll 2
      for (int m = k; m < KC; m += 4) {
        double b[2];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          b[y] = Bs[(16 * me.cb() + 8 * y + me.lane / 4) * LR + m];
        }
#pragma unroll
        for (int x = 0; x < RT; ++x) {
          const double a = -As[me.row(x) * LR + m];
#pragma unroll
          for (int y = 0; y < 2; ++y) dmma_884(acc[x][y], a, b[y]);
        }
      }
    }
    __syncthreads();
    if (ch + NST < CHUNKS) {
      issue_stage<double, ROWS, true>(stages + (ch % NST) * STAGE, A, lda, B,
                                      ldb, (ch + NST) * KC);
    }
  }
}

// acc <- the lane's entries of a float tile's pass (rows from t, ld apart)
template <int TM, int TN>
__device__ __forceinline__ void load_own(float (&acc)[TM][TN], const float* t,
                                         long long ld) {
  const Frag<TM, TN> me;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    chol_panel::load_run<TN>(t + me.row(x) * ld + me.col0(), acc[x]);
  }
}

// the lane's entries, times `scale`, into a float tile's pass
template <int TM, int TN>
__device__ __forceinline__ void store_own(const float (&acc)[TM][TN],
                                          float* t, long long ld,
                                          float scale) {
  const Frag<TM, TN> me;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    float* dst = t + me.row(x) * ld + me.col0();
#pragma unroll
    for (int y = 0; y < TN; y += 4) {
      *reinterpret_cast<float4*>(dst + y) =
          make_float4(scale * acc[x][y], scale * acc[x][y + 1],
                      scale * acc[x][y + 2], scale * acc[x][y + 3]);
    }
  }
}

// zeros over `rows` rows of a float tile
__device__ __forceinline__ void zero_rows(float* t, long long ld, int rows) {
  for (int e = threadIdx.x; e < rows * TILE / 4; e += THREADS) {
    *reinterpret_cast<float4*>(t + (e / (TILE / 4)) * ld +
                               4 * (e % (TILE / 4))) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// TRSM(i, k) on the ROWS rows from r0: L_ik from acc (K's tile for k = 0,
// else L's tile (i, k) as its last update rounded it), against L_kk and
// iL_kk; `below` in iL's tile (i, k); the same rows of the tiles (k, i) of
// L and iL, above the diagonal, zeroed.  Every row of it reads the same
// row of acc, below and R alone.
template <int TM, int TN>
__device__ void trsm(const Args& a, const Task& t, int r0,
                     unsigned char* smem) {
  constexpr int ROWS = Frag<TM, TN>::ROWS;
  const long long M = dim(a);
  const long long acc_ld = t.k == 0 ? a.k_r : M;
  const float* acc_t = (t.k == 0 ? k_tile(a, t.b, t.i, 0)
                                 : l_tile(a, t.b, t.i, t.k)) + r0 * acc_ld;
  const float* Lkk = l_tile(a, t.b, t.k, t.k);
  const float* iLkk = il_tile(a, t.b, t.k, t.k);
  float* below_t = il_tile(a, t.b, t.i, t.k) + r0 * M;
  float* out = l_tile(a, t.b, t.i, t.k) + r0 * M;
  float v[TM][TN];
  zero(v);
  product<TM, TN, true, NT_LOWER, false>(v, acc_t, acc_ld, iLkk, M,
                                                smem);
  store_own(v, below_t, M, 1.0f);
  __syncthreads();
  // R = acc - below L_kk^T, the lane's own entries of acc read first (acc
  // is `out` itself for k > 0)
  zero(v);
  product<TM, TN, true, NT_LOWER, true>(v, below_t, M, Lkk, M, smem);
  {
    float own[TM][TN];
    load_own(own, acc_t, acc_ld);
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) v[x][y] += own[x][y];
  }
  store_own(v, out, M, 1.0f);
  __syncthreads();
  zero(v);
  product<TM, TN, true, NT_LOWER, false>(v, out, M, iLkk, M, smem);
  {
    float own[TM][TN];
    load_own(own, below_t, M);
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) v[x][y] = own[x][y] + v[x][y];
  }
  store_own(v, out, M, 1.0f);
  {  // and its float64 copy, what the updates read
    const Frag<TM, TN> me;
    double* out64 = l64_tile(a, t.b, t.i, t.k) + r0 * M;
#pragma unroll
    for (int x = 0; x < TM; ++x) {
#pragma unroll
      for (int y = 0; y < TN; y += 2) {
        *reinterpret_cast<double2*>(out64 + me.row(x) * M + me.col0() + y) =
            make_double2(v[x][y], v[x][y + 1]);
      }
    }
  }
  zero_rows(l_tile(a, t.b, t.k, t.i) + r0 * M, M, ROWS);
  zero_rows(il_tile(a, t.b, t.k, t.i) + r0 * M, M, ROWS);
}

// UPD(i, k, j) on the 8 RT rows from r0: C_ik -= L_ij L_kj^T in float64,
// from K's tile (j = 0) or the scratch, into the scratch or, by the last
// (j = k - 1), rounded into L's tile (i, k).  On a diagonal tile the warps
// whose columns lie right of every row skip.
template <int RT>
__device__ void upd(const Args& a, const Task& t, int r0,
                    unsigned char* smem) {
  using F = MmaFrag<RT>;
  const long long M = dim(a);
  const F me;
  const bool last = t.j == t.k - 1;
  double* c = c_tile(a, t.b, t.i, t.k) + r0 * TILE;
  const float* kt = k_tile(a, t.b, t.i, t.k) + r0 * a.k_r;
  const bool mine = t.i != t.k || 16 * me.cb() < r0 + F::ROWS;
  double v[RT][2][2];
#pragma unroll
  for (int x = 0; x < RT; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int r = me.row(x), col = me.col(y);
      if (!mine) {
        v[x][y][0] = v[x][y][1] = 0.0;
      } else if (t.j == 0) {
        v[x][y][0] = (double)__ldcg(kt + r * a.k_r + col);
        v[x][y][1] = (double)__ldcg(kt + r * a.k_r + col + 1);
      } else {
        const double2 u =
            __ldcg(reinterpret_cast<const double2*>(c + r * TILE + col));
        v[x][y][0] = u.x;
        v[x][y][1] = u.y;
      }
    }
  mma_update<RT>(v, l64_tile(a, t.b, t.i, t.j) + r0 * M, M,
                 l64_tile(a, t.b, t.k, t.j), M, smem, mine);
  if (mine) {
    float* lt = l_tile(a, t.b, t.i, t.k) + r0 * M;
#pragma unroll
    for (int x = 0; x < RT; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int r = me.row(x), col = me.col(y);
        if (last) {
          lt[r * M + col] = (float)v[x][y][0];
          lt[r * M + col + 1] = (float)v[x][y][1];
        } else {
          *reinterpret_cast<double2*>(c + r * TILE + col) =
              make_double2(v[x][y][0], v[x][y][1]);
        }
      }
  }
}

// ACC(i, j, k): X_ij (iL's tile (i, j)) += L_ik iL_kj; the first term (k
// = j, against iL's diagonal tile) starts X.
__device__ void acc_term(const Args& a, const Task& t, unsigned char* smem) {
  const long long M = dim(a);
  float* x_t = il_tile(a, t.b, t.i, t.j);
  const float* Lik = l_tile(a, t.b, t.i, t.k);
  const float* iLkj = il_tile(a, t.b, t.k, t.j);
  float v[8][8];
  if (t.k == t.j) {
    zero(v);
    product<8, 8, false, NN_LOWER, false>(v, Lik, M, iLkj, M, smem);
  } else {
    load_own(v, x_t, M);
    product<8, 8, false, FULL, false>(v, Lik, M, iLkj, M, smem);
  }
  store_own(v, x_t, M, 1.0f);
}

// INV(i, j): X_ij += L_i,i-1 iL_i-1,j (X starts here where i - 1 = j), then
// iL_ij = -iL_ii X_ij.
__device__ void inv(const Args& a, const Task& t, unsigned char* smem) {
  const long long M = dim(a);
  float* x_t = il_tile(a, t.b, t.i, t.j);
  const float* Lprev = l_tile(a, t.b, t.i, t.i - 1);
  const float* iLprev = il_tile(a, t.b, t.i - 1, t.j);
  float v[8][8];
  if (t.j == t.i - 1) {
    zero(v);
    product<8, 8, false, NN_LOWER, false>(v, Lprev, M, iLprev, M,
                                                 smem);
  } else {
    load_own(v, x_t, M);
    product<8, 8, false, FULL, false>(v, Lprev, M, iLprev, M, smem);
  }
  store_own(v, x_t, M, 1.0f);
  __syncthreads();
  zero(v);
  product<8, 8, false, FULL, false>(v, il_tile(a, t.b, t.i, t.i), M,
                                           x_t, M, smem);
  store_own(v, x_t, M, -1.0f);
}

__device__ __forceinline__ unsigned char* shared_tiles() {
  extern __shared__ __align__(16) unsigned char chol_blocked_smem[];
  return chol_blocked_smem;
}

__global__ void __launch_bounds__(THREADS, 1)
chol_blocked_kernel(const Args a) {
  __shared__ Task s_task;
  unsigned char* smem = shared_tiles();
  const int tid = threadIdx.x;
  const long long total = total_tasks(a.batch, a.nt);
  int* ticket = a.flags + ticket_flag(a.batch, a.nt);
  int panels = 0;  // this block's calls of kernel 9's routine
  Cursor cursor(a.nt);  // thread 0's walk over the keys
  K10_STAMP(long long k10_t = 0; long long k10_ticket = 0;)
  for (;;) {
    if (tid == 0) {
      const long long t = atomicAdd(ticket, 1);
      K10_STAMP(k10_t = t; k10_ticket = k10s::global_ns();)
      Task task = t < total ? cursor.at(t, a.batch)
                            : make(NONE, -1, -1, -1);
      if (task.kind != NONE) {
        Dep deps[MAX_DEPS];
        const int n = deps_of(task, a.batch, a.nt, deps);
        for (int d = 0; d < n; ++d) {
          for (int spins = 0; ld_acquire(a.flags + deps[d].flag) <
                              deps[d].target;
               ++spins) {
            if (spins > WAIT_LIMIT) __trap();
            backoff();
          }
        }
      }
      s_task = task;
    }
    __syncthreads();
    const Task task = s_task;
    if (task.kind == NONE) break;
    K10_STAMP(long long k10_start = tid == 0 ? k10s::global_ns() : 0;)
    switch (task.kind) {
      case POTRF: {
        const float* A = task.k == 0 ? k_tile(a, task.b, 0, 0)
                                     : l_tile(a, task.b, task.k, task.k);
        chol_panel::factor_panel<float>(
            A, task.k == 0 ? a.k_r : dim(a), l_tile(a, task.b, task.k, task.k),
            dim(a), il_tile(a, task.b, task.k, task.k), dim(a), TILE, panels);
        ++panels;
        break;
      }
      case TRSM:  // 32 or 64 rows
        if (task.parts == PARTS) {
          trsm<4, 4>(a, task, task.part * (TILE / PARTS), smem);
        } else {
          trsm<4, 8>(a, task, task.part * (TILE / BULK), smem);
        }
        break;
      case UPD:
        if (task.parts == PARTS) {
          upd<TILE / PARTS / 8>(a, task, task.part * (TILE / PARTS), smem);
        } else {
          upd<TILE / BULK / 8>(a, task, task.part * (TILE / BULK), smem);
        }
        break;
      case ACC:
        acc_term(a, task, smem);
        break;
      default:
        inv(a, task, smem);
        break;
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      red_release_add(a.flags + flag_of(task, a.batch, a.nt),
                      units_of(task));
      K10_STAMP(if (k10_t < k10s::MAX_TASKS) {
        long long* s = k10s::stamps + k10_t * k10s::PER_TASK;
        s[0] = k10_ticket;
        s[1] = k10_start;
        s[2] = k10s::global_ns();
        s[3] = k10s::sm_id();
        s[4] = task.kind;
        s[5] = ((long long)(task.b & 0xff) << 32) |
               ((long long)(task.part & 0xff) << 24) | ((task.i & 0xff) << 16) |
               ((task.k & 0xff) << 8) | (task.j & 0xff);
      })
    }
  }
}

// the dynamic shared memory: kernel 9's panel at TILE, or the stages of
// the largest product
int smem_bytes() {
  const int sizes[] = {
      chol_panel::smem_elems<float>(TILE) * (int)sizeof(float),
      product_smem<64, true>(), product_smem<128, false>(),
      product_smem<32, true>(), mma_smem<TILE / BULK / 8>(),
      mma_smem<TILE / PARTS / 8>()};
  static_assert(product_smem<64, true>() <= SMEM_LIMIT &&
                    product_smem<128, false>() <= SMEM_LIMIT &&
                    product_smem<32, true>() <= SMEM_LIMIT &&
                    mma_smem<TILE / BULK / 8>() <= SMEM_LIMIT &&
                    mma_smem<TILE / PARTS / 8>() <= SMEM_LIMIT,
                "every product within the panel's shared memory");
  int most = 0;
  for (int b : sizes) most = b > most ? b : most;
  return most;
}

// The grid: a block an SM of the current device.
int grid_blocks() {
  static int blocks[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (blocks[dev] == 0) {
    if (cudaFuncSetAttribute(chol_blocked_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes()) != cudaSuccess) {
      return -1;
    }
    int sms = 0, fit = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &fit, chol_blocked_kernel, THREADS, smem_bytes()) != cudaSuccess ||
        fit < 1) {
      return -1;
    }
    blocks[dev] = sms;
  }
  return blocks[dev];
}

int launch(const Args& a, cudaStream_t stream) {
  if (a.batch <= 0 || a.nt <= 0 || a.K == nullptr || a.L == nullptr ||
      a.iL == nullptr || a.L64 == nullptr || a.C == nullptr ||
      a.flags == nullptr ||
      a.k_r < (long long)a.nt * TILE || a.k_r % 4 != 0 || a.k_b % 4 != 0 ||
      total_tasks(a.batch, a.nt) >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = grid_blocks();
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  chol_blocked_kernel<<<grid, THREADS, smem_bytes(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace chol_blocked

// K (batch, M, M), M = nt * 128, through k_b (batch stride) and k_r (row
// stride), in elements, both multiples of 4, its last stride 1 and its
// base 16-byte aligned; L and iL (batch, M, M) contiguous; L64 (batch, M,
// M) float64 contiguous; C (batch, nt (nt + 1) / 2, 128, 128) float64;
// flags n_flags(batch, nt) int32, all zero.  Returns a CUDA error code, 0
// on success.
extern "C" int hetmogp_chol_blocked_f32(const float* K, long long k_b,
                                        long long k_r, float* L, float* iL,
                                        double* L64, double* C, int* flags,
                                        int batch, int nt,
                                        cudaStream_t stream) {
  chol_blocked::Args a;
  a.K = K;
  a.k_b = k_b;
  a.k_r = k_r;
  a.L = L;
  a.iL = iL;
  a.L64 = L64;
  a.C = C;
  a.flags = flags;
  a.batch = batch;
  a.nt = nt;
  return chol_blocked::launch(a, stream);
}

// The counters a launch needs (int32, zeroed by the caller).
extern "C" int hetmogp_chol_blocked_flags(int batch, int nt) {
  return chol_blocked_plan::n_flags(batch, nt);
}

// The blocks of a launch on the current device (-1 where the device
// cannot run it).
extern "C" int hetmogp_chol_blocked_grid() {
  return chol_blocked::grid_blocks();
}

#ifdef K10_STAMPS
// The probe build's stamps of the last launch: `tasks` tickets of
// k10s::PER_TASK into host memory.
extern "C" int hetmogp_chol_blocked_stamps(void* out, long long tasks) {
  if (tasks > chol_blocked::k10s::MAX_TASKS) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaMemcpyFromSymbol(
      out, chol_blocked::k10s::stamps,
      sizeof(long long) * tasks * chol_blocked::k10s::PER_TASK);
}
#endif
