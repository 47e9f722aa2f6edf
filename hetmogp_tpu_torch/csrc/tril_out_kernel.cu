// Kernel 8: the lower triangle of a batched transposed product, Hopper
// (sm_90a).
//
//   out[q, m1, m2] = sum_n A[q, n, m1] * B[q, n, m2]   for m1 >= m2
//   out[q, m1, m2] = 0                                 for m1 <  m2
//
// tril(A^T B).  A and B (Q, N, M), contiguous float32 row-major; out
// (Q, M, M) float32.  Only the lower output tiles are formed: at M = 1024
// 36 of a latent's 64 tiles of 128 x 128, about half the FLOPs of the
// dense product and mask.  The reduction runs over the rows n of both
// operands, so each stage's tiles are rows of A and of B as they are
// stored, and a rank-1 update per row is the natural product.
//
// It replaces no Pallas kernel: the JAX package forms it at the XLA level,
// blocked by hand (hetmogp_tpu/ops/linalg.py:636 t_matmul_tril_out, the L
// gradient of quad_diag_train), and its cached adjoints' Lbar is the same
// masked product at Precision.HIGH (_solve_tri_cached_bwd).  The port runs
// here quad_diag's gL (QuadDiag's backward, every step), the VM step's
// Lbar, and the projections' dL.
//
// What bounds it on an H100, at the VE step's (4, 3072, 1024): Q N M (M+1)
// = 12.9 GFLOP a pass, 0.193 ms in float32 at 67 TFLOP/s and 0.039 ms for
// three bf16 passes at 989 TFLOP/s; 101 MB of operands read and 16.8 MB
// written, 0.035 ms at 3.35 TB/s.  Two designs, for M % 4 == 0 and
// 16-byte-aligned operands (TMA's stride rule; the caller pads a ragged M
// with zeros, ops/cuda_kernels.py::_tma_operands):
//
// 1. tril_out_tma_kernel (entry hetmogp_tril_out_f32, "highest"): full
//    float32 FFMA, no TF32.  tril_tma.cuh's pipeline: one producer thread
//    issues TMA loads of A's and B's BK_F32 x 128 tiles (512-byte rows, as
//    stored) into a ring of 4 stages; 8 FMA warps hold 64 x 32 warp tiles,
//    each lane 8 x 8 outputs, and take each row n of a stage as a rank-1
//    update from four 16-byte shared loads (tril_out_plan.cuh's f32_row,
//    f32_col); the stage pointers are pointer arithmetic on the dynamic
//    shared array, so the loads are LDS.
// 2. tril_out3_tma_kernel (entry hetmogp_tril_out3_f32, "high"): three
//    bf16 passes on wgmma.  Each float32 x is split bit for bit as kernel
//    3's and 5's: hi = x & 0xFFFF0000, lo = bf16_rn(x - hi), and every
//    16-deep step adds lo*hi + hi*lo, then hi*hi, to a float32 sum; lo*lo
//    is dropped.  Both operands arrive as float32 by TMA into a landing
//    ring of 5 stages of BK_3PASS rows: A as four 128-byte-swizzled boxes
//    of 32 columns, B as 512-byte rows.  The two consumer warpgroups (64
//    rows m1 of a 128 x 128 tile each) read their A fragments from the
//    landing slot and split them in registers (tril_out_plan.cuh's
//    afrag_*: conflict-free scalar loads), so A's hi and lo never pass
//    through shared memory; a splitter warpgroup splits B into a ring of
//    4 stages as wgmma's MN-major operand (kernel 5's layout: two
//    64-column boxes, 128-byte swizzled), and its slot of the landing ring
//    is freed once the split values are stored.  Each 16-deep step issues
//    wgmma m64n128k16 with A from registers, B from shared memory,
//    transposed, as one commit group; the fragments alternate between two
//    register sets, and the stage before's B slot is released once its
//    groups are done.  No pre-pass writes split copies to device memory.
//    One thread of a producer warpgroup issues the loads, its three other
//    warps write the mirror tiles' zeros while the products run, and
//    setmaxnreg hands the producer's and the splitter's spare registers to
//    the consumers.  Per stage the block moves 128 KB through shared
//    memory (landing 32, B's split read and written 32, the consumers' A
//    16, wgmma's B 48), where splitting A in shared memory as well would
//    move 168 KB.
//
// Both designs are persistent and walk tril_out_plan.cuh's schedule:
// whole tiles for the full waves, and the last wave's tiles cut into P
// parts of their reduction.  Every part writes its sum to its own slot of
// a float32 scratch, raises its flag and waits for the tile's P flags;
// then each part reduces its own 1/P of the tile, adding the P partials
// in part order, so the fix-up runs on P blocks at once, in a fixed order
// (no atomics on values: two launches are bitwise equal, as a graph
// replay and the eager step it was captured from must be).  Ragged N, and
// m1 or m2 past M, arrive as TMA's zero fill.  Above the diagonal nothing
// is computed: the block of a lower tile writes its mirror's zeros, and a
// diagonal tile's epilogue zeroes m1 < m2.
//
// On the card, chip_smoke.py's tril_out_phase holds both designs to their
// plain versions and float64, two launches bitwise equal, and times it
// beside cuBLAS's dense A^T B and mask; probes/tril_out.py times the TMA
// designs against another checkout's, with per-role clock stamps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tril_out_plan.cuh"
#include "tril_tma.cuh"

namespace {

using tril_out_plan::keep;

// The bit-mask split of two float32 (x.x in the low half): hi's and lo's
// bf16 pairs.
__device__ __forceinline__ void split2(float2 x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(x.x) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(x.y) & 0xFFFF0000u;
  hi = (h0 >> 16) | h1;
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - __uint_as_float(h0),
                                                  x.y - __uint_as_float(h1));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- probe stamps ------------------------------------------------------------
//
// A probe build (nvcc -DK8_STAMPS; probes/tril_out.py) has each role's
// first thread add up clock64() cycles by what it waits for and what it
// does, and store them per block in `stamps` for the host to read
// (hetmogp_tril_out_stamps).  In the shipped build K8_STAMP(...) is empty.

namespace k8s {
enum Stamp {
  BLOCK,          // the first consumer thread, kernel start to end
  STAGES,         // stages it consumed
  PRODUCER_WAIT,  // the loading thread waiting for a free slot
  SPLIT_WAIT,     // the first splitter thread waiting for a loaded stage
  SPLIT_BUSY,     // and with one, its slot waits included (3-pass)
  CONSUMER_WAIT,  // the first consumer thread waiting for a stage
  LOOP,           // its stage loops, waits included
  FLAG_WAIT,      // raising its flag, waiting for the split tile's
  FIXUP,          // reading and adding its share of the tile's partials
  PARTIAL,        // writing its partial and fencing it
  EPILOGUE,       // storing the tile (and, FFMA, its mirror's zeros)
  START_NS,       // %globaltimer at the start of the block
  END_NS,         // and at its end
  SPLIT_SLOT_WAIT,  // the first splitter thread waiting for a free slot
  N_STAMPS = 16
};
#ifdef K8_STAMPS
constexpr int MAX_BLOCKS = 1024;
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
}  // namespace k8s

#ifdef K8_STAMPS
#define K8_STAMP(...) __VA_ARGS__
#else
#define K8_STAMP(...)
#endif

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A split tile's flags: part k raises ready[base + k] (release) once its
// partial is written, and every part waits (acquire) for all P of them.
// The last part past its wait (a count on gone[base]) lowers the P flags
// and the count again, so every launch starts and ends with them down.
__device__ __forceinline__ void raise_flag(uint32_t* flag) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(flag), "r"(1u)
               : "memory");
}

constexpr long long FLAG_SPINS = 1ll << 24;

__device__ __forceinline__ void meet(uint32_t* ready, uint32_t* gone,
                                     int base, int parts) {
  for (int k = 0; k < parts; ++k) {
    for (long long spins = 0;; ++spins) {
      uint32_t up;
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(up)
                   : "l"(ready + base + k)
                   : "memory");
      if (up) break;
      if (spins > FLAG_SPINS) __trap();
      __nanosleep(32);
    }
  }
  if (atomicAdd(gone + base, 1u) == (uint32_t)(parts - 1)) {
    for (int k = 0; k < parts; ++k) ready[base + k] = 0u;  // next launch's
    gone[base] = 0u;
  }
}

// Part w of a split tile, once the tile's P partials are written: its
// float4s [v0, v1) of the tile, each the sum of the P slots in part order
// ((p_0 + p_1) + ...) + p_{P-1}, its loads issued FIX_LOADS at a time
// before their adds, stored with the diagonal's mask; and, with MIRROR,
// the same float4s of the mirror tile's zeros (else zero_mirrors writes
// them).  (Sixteen loads at a time made ptxas allocate the FFMA design's
// main loop worse: 9% slower at VE on an H100.)
constexpr int FIX_LOADS = 4;

template <bool MIRROR>
__device__ __forceinline__ void reduce_part(const tril_out_plan::Work& w,
                                            const float* partials,
                                            float* out, int M, int tid,
                                            int threads) {
  using tril_out_plan::BT;
  const float4* part = reinterpret_cast<const float4*>(partials);
  float* outq = out + (size_t)w.q * M * M;
  for (int v = w.v0() + tid; v < w.v1(); v += threads) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k0 = 0; k0 < w.parts; k0 += FIX_LOADS) {
      float4 x[FIX_LOADS];
#pragma unroll
      for (int k = 0; k < FIX_LOADS; ++k) {
        if (k0 + k < w.parts) {
          x[k] = __ldcg(part + tril_out_plan::slot_at(w.base + k0 + k) / 4 +
                        v);
        }
      }
#pragma unroll
      for (int k = 0; k < FIX_LOADS; ++k) {
        if (k0 + k == 0) {
          s = x[0];
        } else if (k0 + k < w.parts) {
          s.x += x[k].x;
          s.y += x[k].y;
          s.z += x[k].z;
          s.w += x[k].w;
        }
      }
    }
    const int row = v / (BT / 4), c = 4 * (v % (BT / 4));
    const int m1 = w.i * BT + row, m2 = w.j * BT + c;
    if (m1 < M && m2 < M) {  // M % 4 == 0: m2 + 3 < M too
      if (w.i == w.j) {
        if (!keep(m1, m2)) s.x = 0.0f;
        if (!keep(m1, m2 + 1)) s.y = 0.0f;
        if (!keep(m1, m2 + 2)) s.z = 0.0f;
        if (!keep(m1, m2 + 3)) s.w = 0.0f;
      }
      *reinterpret_cast<float4*>(outq + (size_t)m1 * M + m2) = s;
    }
    const int r = w.j * BT + row, cc = w.i * BT + c;
    if (MIRROR && w.i > w.j && r < M && cc < M) {
      *reinterpret_cast<float4*>(outq + (size_t)r * M + cc) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The zeros above the diagonal that block b's units own: for each lower
// tile (i, j), i > j, of its turns, the mirror tile (j, i) (of a split
// tile, the part's float4s [v0, v1) of it), row-major, by `threads`
// threads that take no part in the products (the three-pass design's idle
// producer warps), while the products run: so the stores at the end of a
// tile are its values alone.
__device__ __forceinline__ void zero_mirrors(const tril_out_plan::Plan& plan,
                                             float* out, int M, int t,
                                             int threads) {
  using tril_out_plan::BT;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int turn = 0; turn < plan.turns(blockIdx.x); ++turn) {
    const tril_out_plan::Work w = plan.work(blockIdx.x, turn);
    if (w.i == w.j) continue;
    float* outq = out + (size_t)w.q * M * M;
    for (int v = w.v0() + t; v < w.v1(); v += threads) {
      const int r = w.j * BT + v / (BT / 4), c = w.i * BT + 4 * (v % (BT / 4));
      if (r < M && c < M) {  // M % 4 == 0: c + 3 < M too
        *reinterpret_cast<float4*>(outq + (size_t)r * M + c) = zero;
      }
    }
  }
}

}  // namespace

// ---- the FFMA design ("highest") --------------------------------------------

namespace k8f {

using namespace tril_out_plan;

constexpr int BK = BK_F32;
constexpr int STAGES = 4;
constexpr int WARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int TILE_BYTES = BK * BT * 4;  // BK rows of 128 floats, as stored
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // A's tile, then B's
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int CONSUMER_BAR = 1;
static_assert(CONSUMERS == 8 * 32, "eight FMA warps of 64 x 32");

__device__ uint32_t ready[MAX_SLOTS];
__device__ uint32_t gone[MAX_SLOTS];

// acc[i][j] += sum over the stage's BK rows n of A[n][row i] B[n][col j],
// one FMA chain per output in increasing n.
__device__ __forceinline__ void consume(const float* As, const float* Bs,
                                        float (&acc)[8][8], int tid) {
  const float* ap = As + f32_row(tid, 0);
  const float* bp = Bs + f32_col(tid, 0);
#pragma unroll 4
  for (int n = 0; n < BK; ++n) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + n * BT);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + n * BT + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(bp + n * BT);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + n * BT + 16);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace k8f

__global__ void __launch_bounds__(k8f::THREADS, 1)
tril_out_tma_kernel(const __grid_constant__ CUtensorMap mapA,
                    const __grid_constant__ CUtensorMap mapB,
                    float* __restrict__ out, float* __restrict__ partials,
                    int M, const __grid_constant__ tril_out_plan::Plan plan) {
  using namespace k8f;
  extern __shared__ uint8_t smem_raw[];
  // stages on 1024-byte boundaries; pointer arithmetic on smem_raw, not a
  // round trip through an integer, keeps the reads shared loads (LDS)
  uint8_t* smem =
      smem_raw + ((1024 - (tril_tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tril_tma::mbar_init(full + s, 1);
      tril_tma::mbar_init(empty + s, WARPS);
    }
    tril_tma::fence_barrier_init();
  }
  __syncthreads();
  K8_STAMP(long long k8[k8s::N_STAMPS] = {}; long long k8_t = clock64();
           const long long k8_start = k8_t;
           if (tid == 0) k8s::put(k8s::START_NS, k8s::global_ns());)

  if (tid >= CONSUMERS) {  // the producer
    if (tid != CONSUMERS) return;
    tril_tma::Ring ring;
    for (Cursor c(plan, blockIdx.x); !c.done; c.next()) {
      K8_STAMP(k8_t = clock64();)
      tril_tma::mbar_wait(empty + ring.slot, ring.phase ^ 1);
      K8_STAMP(k8[k8s::PRODUCER_WAIT] += clock64() - k8_t;)
      uint8_t* st = smem + ring.slot * STAGE_BYTES;
      uint64_t* bar = full + ring.slot;
      tril_tma::mbar_expect_tx(bar, STAGE_BYTES);
      tril_tma::tma_load_3d(st, &mapA, bar, c.w.i * BT, c.s * BK, c.w.q);
      tril_tma::tma_load_3d(st + TILE_BYTES, &mapB, bar, c.w.j * BT,
                            c.s * BK, c.w.q);
      ring.advance(STAGES);
    }
    K8_STAMP(k8s::put(k8s::PRODUCER_WAIT, k8[k8s::PRODUCER_WAIT]);)
    return;
  }

  tril_tma::Ring ring;
  for (int turn = 0; turn < plan.turns(blockIdx.x); ++turn) {
    const Work w = plan.work(blockIdx.x, turn);
    K8_STAMP(const long long k8_loop = clock64();)
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int s = w.s0; s < w.s1; ++s) {
      K8_STAMP(k8_t = clock64();)
      tril_tma::mbar_wait(full + ring.slot, ring.phase);
      K8_STAMP(k8[k8s::CONSUMER_WAIT] += clock64() - k8_t;
               ++k8[k8s::STAGES];)
      const float* As =
          reinterpret_cast<const float*>(smem + ring.slot * STAGE_BYTES);
      consume(As, As + BK * BT, acc, tid);
      __syncwarp();
      if (lane == 0) tril_tma::mbar_arrive(empty + ring.slot);
      ring.advance(STAGES);
    }
    K8_STAMP(k8[k8s::LOOP] += clock64() - k8_loop; k8_t = clock64();)

    if (w.role == PART) {
      // this part's sum into its slot, in the tile's layout
      float* slot = partials + slot_at(w.slot());
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float4*>(slot + f32_row(tid, i) * BT +
                                     f32_col(tid, 4 * h)) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      }
      __threadfence();
      named_barrier(CONSUMER_BAR, CONSUMERS);
      K8_STAMP(k8[k8s::PARTIAL] += clock64() - k8_t; k8_t = clock64();)
      if (tid == 0) {
        raise_flag(ready + w.slot());
        meet(ready, gone, w.base, w.parts);
      }
      named_barrier(CONSUMER_BAR, CONSUMERS);
      K8_STAMP(k8[k8s::FLAG_WAIT] += clock64() - k8_t; k8_t = clock64();)
      reduce_part<true>(w, partials, out, M, tid, CONSUMERS);
      K8_STAMP(k8[k8s::FIXUP] += clock64() - k8_t;)
      continue;
    }

    float* outq = out + (size_t)w.q * M * M;
    const int m1_0 = w.i * BT, m2_0 = w.j * BT;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m1 = m1_0 + f32_row(tid, i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m2 = m2_0 + f32_col(tid, 4 * h);
        if (m1 < M && m2 < M) {  // M % 4 == 0: m2 + 3 < M too
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
          if (w.i == w.j) {
            if (!keep(m1, m2)) v.x = 0.0f;
            if (!keep(m1, m2 + 1)) v.y = 0.0f;
            if (!keep(m1, m2 + 2)) v.z = 0.0f;
            if (!keep(m1, m2 + 3)) v.w = 0.0f;
          }
          *reinterpret_cast<float4*>(outq + (size_t)m1 * M + m2) = v;
        }
        // the mirror tile above the diagonal
        const int r = m2_0 + f32_row(tid, i), c = m1_0 + f32_col(tid, 4 * h);
        if (w.i > w.j && r < M && c < M) {
          *reinterpret_cast<float4*>(outq + (size_t)r * M + c) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    }
    K8_STAMP(k8[k8s::EPILOGUE] += clock64() - k8_t;)
  }
  K8_STAMP(if (tid == 0) {
    k8[k8s::BLOCK] = clock64() - k8_start;
    k8s::put(k8s::END_NS, k8s::global_ns());
    for (int k = 0; k < k8s::START_NS; ++k)
      if (k != k8s::PRODUCER_WAIT) k8s::put(k, k8[k]);
  })
}

// ---- the three-pass wgmma design ("high") ----------------------------------

namespace k8w {

using namespace tril_out_plan;

constexpr int BK = BK_3PASS;
constexpr int A_BOX = BK * 128;              // A: BK rows x 32 floats, swizzled
constexpr int A_BOXES = BT / 32;
constexpr int TILE_BYTES = BK * BT * 4;      // one operand's float32 tile
constexpr int LAND_BYTES = 2 * TILE_BYTES;   // A's four boxes, then B's tile
constexpr int HALF = BK * 128;               // one BK x 64 bf16 box
constexpr int SPLIT_BYTES = 4 * HALF;        // B's hi, then its lo
constexpr int LAND_STAGES = 5;               // the float32 landing ring
constexpr int SPLIT_STAGES = 4;              // B's split ring
constexpr int STEPS = BK / 16;               // 16-deep steps of a stage
constexpr int PRODUCERS = 128;               // a warpgroup; one thread loads
constexpr int THREADS = CONSUMERS + SPLITTERS + PRODUCERS;
constexpr int BARRIERS = 2 * LAND_STAGES + 2 * SPLIT_STAGES;
constexpr int SMEM_BYTES = LAND_STAGES * LAND_BYTES +
                           SPLIT_STAGES * SPLIT_BYTES + BARRIERS * 8 + 1024;
static_assert(SMEM_BYTES <= 227 * 1024, "a block's shared memory");
static_assert(A_BOXES * A_BOX == TILE_BYTES, "A's boxes fill its tile");
static_assert(SPLIT_BYTES == TILE_BYTES, "hi and lo take the float32 bytes");
// setmaxnreg: the producer warpgroup keeps PRODUCER_REGS, the splitter
// warpgroup SPLIT_REGS (its split values and addresses), and the consumers
// take the rest of the block's (ptxas's cap, 65536 / THREADS)
constexpr int BLOCK_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int SPLIT_REGS = SPLIT_VEC * 4 + 32;
constexpr int CONSUMER_REGS =
    (BLOCK_REGS * THREADS - SPLIT_REGS * SPLITTERS -
     PRODUCER_REGS * PRODUCERS) / CONSUMERS / 8 * 8;
constexpr int REGS_HANDED = PRODUCER_REGS * PRODUCERS +
                            SPLIT_REGS * SPLITTERS +
                            CONSUMER_REGS * CONSUMERS;
constexpr int CONSUMER_BAR = 1;  // the consumers' named barrier (split tiles)

__device__ uint32_t ready[MAX_SLOTS];
__device__ uint32_t gone[MAX_SLOTS];

// wgmma descriptor of a 128-byte-swizzled MN-major tile at p (1024-byte
// aligned): K rows of 64 bf16 (128 bytes) of M or N, 8-row groups 1024
// bytes apart (SBO), the second 64 columns HALF bytes on (LBO).  Adding
// 128 moves it 16 rows deeper along K.
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return (uint64_t)((tril_tma::smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(HALF >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128 over the warpgroup) += a b: a the warp's 16 x 16 bf16
// fragment in registers (wgmma's A layout), b the MN-major 16 x 128 bf16
// tile named by db (wgmma transposes it).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One arrival on `bar` where `pred` holds, as a predicated instruction (a
// branch around it, with products still running, would make ptxas
// serialize them).
__device__ __forceinline__ void arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(tril_tma::smem_addr(bar)),
      "r"((int)pred)
      : "memory");
}

}  // namespace k8w

__global__ void __launch_bounds__(k8w::THREADS, 1)
tril_out3_tma_kernel(const __grid_constant__ CUtensorMap mapA,
                     const __grid_constant__ CUtensorMap mapB,
                     float* __restrict__ out, float* __restrict__ partials,
                     int M, const __grid_constant__ tril_out_plan::Plan plan) {
  using namespace k8w;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on it.
  // Pointer arithmetic on smem_raw keeps the fragment and splitter reads
  // and writes shared loads and stores (LDS, STS).
  uint8_t* land =
      smem_raw + ((1024 - (tril_tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* split = land + LAND_STAGES * LAND_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(split + SPLIT_STAGES * SPLIT_BYTES);
  uint64_t* landed = full + LAND_STAGES;  // a landing slot read: free
  uint64_t* split_full = landed + LAND_STAGES;
  uint64_t* split_empty = split_full + SPLIT_STAGES;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < LAND_STAGES; ++s) {
      tril_tma::mbar_init(full + s, 1);
      tril_tma::mbar_init(landed + s, (SPLITTERS + CONSUMERS) / 32);
    }
    for (int s = 0; s < SPLIT_STAGES; ++s) {
      tril_tma::mbar_init(split_full + s, SPLITTERS / 32);
      tril_tma::mbar_init(split_empty + s, CONSUMERS / 32);
    }
    tril_tma::fence_barrier_init();
  }
  __syncthreads();
  K8_STAMP(long long k8[k8s::N_STAMPS] = {}; long long k8_t = clock64();
           const long long k8_start = k8_t;
           if (tid == 0) k8s::put(k8s::START_NS, k8s::global_ns());)

  if (tid >= CONSUMERS + SPLITTERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (tid >= CONSUMERS + SPLITTERS + 32) {  // three idle warps
      zero_mirrors(plan, out, M, tid - CONSUMERS - SPLITTERS - 32,
                   PRODUCERS - 32);
      return;
    }
    if (tid != CONSUMERS + SPLITTERS) return;
    tril_tma::Ring ring;
    for (Cursor c(plan, blockIdx.x); !c.done; c.next()) {
      K8_STAMP(k8_t = clock64();)
      tril_tma::mbar_wait(landed + ring.slot, ring.phase ^ 1);
      K8_STAMP(k8[k8s::PRODUCER_WAIT] += clock64() - k8_t;)
      uint8_t* st = land + ring.slot * LAND_BYTES;
      uint64_t* bar = full + ring.slot;
      tril_tma::mbar_expect_tx(bar, LAND_BYTES);
#pragma unroll
      for (int b = 0; b < A_BOXES; ++b) {
        tril_tma::tma_load_3d(st + b * A_BOX, &mapA, bar, c.w.i * BT + 32 * b,
                              c.s * BK, c.w.q);
      }
      tril_tma::tma_load_3d(st + TILE_BYTES, &mapB, bar, c.w.j * BT,
                            c.s * BK, c.w.q);
      ring.advance(LAND_STAGES);
    }
    K8_STAMP(k8s::put(k8s::PRODUCER_WAIT, k8[k8s::PRODUCER_WAIT]);)
    return;
  }
  if (tid >= CONSUMERS) {  // the splitter: B's tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SPLIT_REGS)
                 : "memory");
    const int t = tid - CONSUMERS;
    tril_tma::Ring lr, sr;
    for (Cursor c(plan, blockIdx.x); !c.done; c.next()) {
      K8_STAMP(k8_t = clock64();)
      tril_tma::mbar_wait(full + lr.slot, lr.phase);
      K8_STAMP(k8[k8s::SPLIT_WAIT] += clock64() - k8_t; k8_t = clock64();)
      const uint8_t* lt = land + lr.slot * LAND_BYTES + TILE_BYTES;
      uint2 hi[SPLIT_VEC], lo[SPLIT_VEC];
#pragma unroll
      for (int i = 0; i < SPLIT_VEC; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            lt + split_row(t, i) * (BT * 4) + split_c4(t, i) * 16);
        split2(make_float2(v.x, v.y), hi[i].x, lo[i].x);
        split2(make_float2(v.z, v.w), hi[i].y, lo[i].y);
      }
      K8_STAMP(const long long k8_s = clock64();)
      tril_tma::mbar_wait(split_empty + sr.slot, sr.phase ^ 1);
      K8_STAMP(k8[k8s::SPLIT_SLOT_WAIT] += clock64() - k8_s;)
      uint8_t* st = split + sr.slot * SPLIT_BYTES;
#pragma unroll
      for (int i = 0; i < SPLIT_VEC; ++i) {
        const int off = split_offset(split_row(t, i), split_c4(t, i));
        *reinterpret_cast<uint2*>(st + off) = hi[i];
        *reinterpret_cast<uint2*>(st + 2 * HALF + off) = lo[i];
      }
      // the generic-proxy writes, before wgmma reads them (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      // The landing slot's B is free only now: its loads' values have been
      // stored, so they have arrived.  (An arrival right after the loads
      // does not wait for them, and ptxas moves the splits that use them
      // past it: the next TMA load into the slot then races them.)
      if (lane == 0) {
        tril_tma::mbar_arrive(split_full + sr.slot);
        tril_tma::mbar_arrive(landed + lr.slot);
      }
      sr.advance(SPLIT_STAGES);
      lr.advance(LAND_STAGES);
      K8_STAMP(k8[k8s::SPLIT_BUSY] += clock64() - k8_t;)
    }
    K8_STAMP(if (t == 0) {
      k8s::put(k8s::SPLIT_WAIT, k8[k8s::SPLIT_WAIT]);
      k8s::put(k8s::SPLIT_BUSY, k8[k8s::SPLIT_BUSY]);
      k8s::put(k8s::SPLIT_SLOT_WAIT, k8[k8s::SPLIT_SLOT_WAIT]);
    })
    return;
  }

  // the consumers: warpgroup g holds rows m1 in [64 g, 64 g + 64), and
  // each thread reads and splits its A fragments itself
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  int aoff[4];  // the fragments' byte offsets in A's boxes, at kk = 0
#pragma unroll
  for (int e = 0; e < 4; ++e) aoff[e] = afrag_offset(tid, 0, e);
  tril_tma::Ring lr, sr;
  for (int turn = 0; turn < plan.turns(blockIdx.x); ++turn) {
    const Work w = plan.work(blockIdx.x, turn);
    K8_STAMP(const long long k8_loop = clock64();)
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    uint32_t frag[2][8];  // a step's ahi[4], alo[4]; two steps in flight
    for (int s = w.s0; s < w.s1; ++s) {
      K8_STAMP(k8_t = clock64();)
      tril_tma::mbar_wait(full + lr.slot, lr.phase);
      tril_tma::mbar_wait(split_full + sr.slot, sr.phase);
      K8_STAMP(k8[k8s::CONSUMER_WAIT] += clock64() - k8_t;
               ++k8[k8s::STAGES];)
      const uint8_t* at = land + lr.slot * LAND_BYTES;
      const uint8_t* st = split + sr.slot * SPLIT_BYTES;
      const uint64_t bhi = mn_desc(st);
      const uint64_t blo = mn_desc(st + 2 * HALF);
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        uint32_t* ahi = frag[kk & 1];
        uint32_t* alo = frag[kk & 1] + 4;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int e = 2 * x;  // elements e, e + 1 of the fragment
          const float2 v = make_float2(
              *reinterpret_cast<const float*>(at + aoff[e & 3] +
                                              afrag_step(kk, e)),
              *reinterpret_cast<const float*>(at + aoff[(e + 1) & 3] +
                                              afrag_step(kk, e + 1)));
          split2(v, ahi[x], alo[x]);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_rs(acc, alo, bhi + 128 * kk);  // the small terms first
        wgmma_rs(acc, ahi, blo + 128 * kk);
        wgmma_rs(acc, ahi, bhi + 128 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the step before is done: its fragment registers are free again,
        // and at kk = 0 the stage before's B slot
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kk == 0) {
          arrive_if(split_empty + (sr.slot + SPLIT_STAGES - 1) % SPLIT_STAGES,
                    lane == 0 && s > w.s0);
        }
      }
      // the products took this stage's A fragments from registers: its
      // landing slot is read
      arrive_if(landed + lr.slot, lane == 0);
      lr.advance(LAND_STAGES);
      sr.advance(SPLIT_STAGES);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    arrive_if(split_empty + (sr.slot + SPLIT_STAGES - 1) % SPLIT_STAGES,
              lane == 0);
    K8_STAMP(k8[k8s::LOOP] += clock64() - k8_loop; k8_t = clock64();)
    if (w.role == PART) {
      // this part's sum into its slot, in the tile's layout: accumulator
      // 2 x at a fixed offset from the thread's first
      float* slot = partials + slot_at(w.slot()) + acc_row(tid, 0) * BT +
                    acc_col(tid, 0);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        *reinterpret_cast<float2*>(
            slot + (acc_row(0, 2 * x) - acc_row(0, 0)) * BT +
            acc_col(0, 2 * x) - acc_col(0, 0)) =
            make_float2(acc[2 * x], acc[2 * x + 1]);
      }
      __threadfence();
      named_barrier(CONSUMER_BAR, CONSUMERS);
      K8_STAMP(k8[k8s::PARTIAL] += clock64() - k8_t; k8_t = clock64();)
      if (tid == 0) {
        raise_flag(ready + w.slot());
        meet(ready, gone, w.base, w.parts);
      }
      named_barrier(CONSUMER_BAR, CONSUMERS);
      K8_STAMP(k8[k8s::FLAG_WAIT] += clock64() - k8_t; k8_t = clock64();)
      reduce_part<false>(w, partials, out, M, tid, CONSUMERS);
      K8_STAMP(k8[k8s::FIXUP] += clock64() - k8_t;)
      continue;
    }

    // accumulator 4 j + 2 h + e: row acc_row(tid, 2 h), column
    // acc_col(tid, 4 j) + e
    float* outq = out + (size_t)w.q * M * M;
    const int m1_0 = w.i * BT, m2_0 = w.j * BT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(tid, 2 * h);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = acc_col(tid, 4 * j);
        const int m1 = m1_0 + r, m2 = m2_0 + c;
        if (m1 < M && m2 < M) {  // M % 4 == 0, m2 even: m2 + 1 < M too
          float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (w.i == w.j) {
            if (!keep(m1, m2)) v.x = 0.0f;
            if (!keep(m1, m2 + 1)) v.y = 0.0f;
          }
          *reinterpret_cast<float2*>(outq + (size_t)m1 * M + m2) = v;
        }
      }
    }
    K8_STAMP(k8[k8s::EPILOGUE] += clock64() - k8_t;)
  }
  K8_STAMP(if (tid == 0) {
    k8[k8s::BLOCK] = clock64() - k8_start;
    k8s::put(k8s::END_NS, k8s::global_ns());
    for (int k = 0; k < k8s::START_NS; ++k)
      if (k != k8s::PRODUCER_WAIT && k != k8s::SPLIT_WAIT &&
          k != k8s::SPLIT_BUSY)
        k8s::put(k, k8[k]);
  })
}

// Plain C entry points, bound with ctypes.  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success), or a
// negative CUresult when a tensor map cannot be encoded.  The caller checks
// shapes, dtype, contiguity and device, and N > 0.  Launches of one design
// in one process on one device must not overlap: they share the split
// tiles' flags.

namespace {

int bk_of(int three) {
  return three ? tril_out_plan::BK_3PASS : tril_out_plan::BK_F32;
}

tril_out_plan::Plan plan_of(int Q, int N, int M, int three, int sms) {
  return tril_out_plan::make_plan(Q, N, M, bk_of(three), sms);
}

bool bad_shape(int Q, int N, int M) {
  return Q <= 0 || N <= 0 || M <= 0 ||
         (long long)Q * ((M + 127) / 128) * ((M + 127) / 128 + 1) / 2 >
             2147483647LL;
}

// `regs_handed`: the registers a block's setmaxnreg hands out, 0 where
// it does not: a build whose register count cannot back them is refused
// (setmaxnreg.inc would wait for ever).
template <typename Kernel>
int launch_tma(Kernel kernel, int smem_bytes, int threads, int regs_handed,
               bool& attr_set, const float* A, const float* B, float* out,
               float* partials, int Q, int N, int M, int three,
               cudaStream_t stream) {
  using namespace tril_out_plan;
  if (bad_shape(Q, N, M) || M % 4 != 0) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_of(Q, N, M, three, tril_tma::sm_count());
  if (plan.slots() && partials == nullptr) return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (regs_handed > 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * threads < regs_handed) {
      return (int)cudaErrorInvalidConfiguration;
    }
  }
  // A's boxes: 512-byte rows as stored (FFMA), or, for the three-pass
  // consumers' fragments, 32 columns 128-byte swizzled
  CUtensorMap mapA, mapB;
  const int bk = bk_of(three);
  int err = tril_tma::encode_3d(
      &mapA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, M, N, Q, 4ull * M,
      4ull * N * M, three ? 32 : BT, bk,
      three ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapB, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, B, M, N,
                            Q, 4ull * M, 4ull * N * M, BT, bk,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  kernel<<<plan.G, threads, smem_bytes, stream>>>(mapA, mapB, out, partials,
                                                  M, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of partial-sum scratch a TMA launch at (Q, N, M) needs (`three`:
// the three-pass design): one 128 x 128 tile for each part of a split
// tile, 0 where the plan splits none.
extern "C" long long hetmogp_tril_out_partials(int Q, int N, int M,
                                               int three) {
  using namespace tril_out_plan;
  if (bad_shape(Q, N, M)) return 0;
  const Plan p = plan_of(Q, N, M, three, tril_tma::sm_count());
  return (long long)p.slots() * BT * BT;
}

// The schedule at (Q, N, M) on `sms` SMs: blocks, whole turns, tiles of
// the last turn, their parts, the busiest block's stages, all blocks'
// stages, and the most partial float4s a block reads in its fix-up.  For
// chip_smoke.py's report.
extern "C" int hetmogp_tril_out_schedule(int Q, int N, int M, int three,
                                         int sms, long long* out7) {
  using namespace tril_out_plan;
  if (bad_shape(Q, N, M) || sms <= 0) return -1;
  const Plan p = plan_of(Q, N, M, three, sms);
  long long total = 0;
  for (int b = 0; b < p.G; ++b) total += block_stages(p, b);
  out7[0] = p.G;
  out7[1] = p.F;
  out7[2] = p.rem;
  out7[3] = p.P;
  out7[4] = busiest(p);
  out7[5] = total;
  out7[6] = most_fixup_reads(p);
  return 0;
}

#ifdef K8_STAMPS
// A probe build's stamps of the last launch: k8s::N_STAMPS a block for the
// first `blocks` blocks, into host memory.  Returns cudaMemcpyFromSymbol's
// error.
extern "C" int hetmogp_tril_out_stamps(long long* host, int blocks) {
  if (blocks > k8s::MAX_BLOCKS) blocks = k8s::MAX_BLOCKS;
  return (int)cudaMemcpyFromSymbol(
      host, k8s::stamps, sizeof(long long) * k8s::N_STAMPS * blocks);
}
#endif

// The FFMA design: M % 4 == 0 and A, B and out 16-byte aligned.
extern "C" int hetmogp_tril_out_f32(const float* A, const float* B,
                                    float* out, float* partials, int Q, int N,
                                    int M, cudaStream_t stream) {
  static bool attr_set = false;
  return launch_tma(tril_out_tma_kernel, k8f::SMEM_BYTES, k8f::THREADS, 0,
                    attr_set, A, B, out, partials, Q, N, M, 0, stream);
}

// The three-pass wgmma design: M % 4 == 0 and A, B and out 16-byte aligned.
extern "C" int hetmogp_tril_out3_f32(const float* A, const float* B,
                                     float* out, float* partials, int Q,
                                     int N, int M, cudaStream_t stream) {
  static bool attr_set = false;
  return launch_tma(tril_out3_tma_kernel, k8w::SMEM_BYTES, k8w::THREADS,
                    k8w::REGS_HANDED, attr_set, A, B, out, partials, Q, N,
                    M, 1, stream);
}
