// Kernel 5: batched product with a lower-triangular right factor in three
// bf16 tensor-core passes, Hopper (sm_90a).
//
//   out[q, n, k] = sum_{m >= k} A[q, n, m] * L[q, m, k]      (A tril(L))
//
// A (Q, N, M) and L (Q, M, M), contiguous float32 row-major, M % 4 == 0 and
// 16-byte-aligned bases (TMA's stride rule); out (Q, N, M) float32.  L's
// strictly upper entries are never used: they count as zero whatever they
// hold.  Each float32 operand x is split into two bf16 values, hi = x with
// its low 16 bits cleared and lo = bf16_rn(x - hi), and every 16-deep step
// of the reduction adds lo*hi + hi*lo, then hi*hi, to a float32
// accumulator on the tensor cores; the lo*lo term is dropped.  The split
// is kernel 3's (tril_proj3_kernel.cu), bit for bit.
//
// It replaces no Pallas kernel: it is what the JAX package's cached-inverse
// adjoints compute at Precision.HIGH (hetmogp_tpu/ops/linalg.py:189:
// _chol_cached_bwd's three products, _solve_tri_cached_bwd's Bbar), which
// the port runs at ve_fwd_precision="high" in the VM step: three launches
// at (4, 1024, 1024) and one at (4, 768, 1024) a VM step.
//
// What bounds it on an H100: three passes of Q N M (M + 1) triangular
// FLOPs at 989 TFLOP/s of dense bf16 (0.0391 ms at (4, 3072, 1024)),
// against its operands and output at 3.35 TB/s (0.0150 ms at (4, 1024,
// 1024)).  What its design does about that (tril_right3_plan.cuh holds the
// schedule, which the CPU tests walk):
//
// * No pre-pass: L arrives as float32 by TMA, a 64 m x 128 k box of
//   512-byte rows a stage (32 KB, the bytes of its hi and lo), and a
//   splitter warpgroup splits it in shared memory: each thread reads its
//   16 float4, the warpgroup meets a named barrier, and it writes hi and
//   lo over them as wgmma's MN-major operand (two 64 x 64 bf16 boxes
//   each, 128-byte swizzled), zeroing m < k in the stages that straddle
//   the diagonal; a proxy fence, then the stage's "split" barrier.  One
//   thread of a producer warpgroup issues the TMA loads as soon as a
//   slot is free, so the split's latency never delays a load.
//   setmaxnreg hands the producer's and the splitter's spare registers to
//   the consumers.
// * Two consumer warpgroups each own 64 rows of a 128 x 128 output tile
//   (wgmma m64n128k16, 64 float32 accumulators a thread).  Per 16-deep
//   step a warp reads its A fragment from the float32 tile (two
//   128-byte-swizzled boxes of 32 floats a row), splits it in registers and
//   issues alo lhi, ahi llo, ahi lhi as one commit group, then waits for
//   the step before (wait_group 1): the next step's fragment is read and
//   split while this one's products run, and a stage is released as soon
//   as the next one's first products are issued.
// * The stage pointers are pointer arithmetic on the dynamic shared array,
//   so every fragment read is a shared load (LDS), not a generic one.
// * Persistent blocks on tril_right3_plan.cuh's snake; at the VM shape
//   column tile 0 runs as two parts on two blocks, whose sums meet through
//   a scratch partial and a flag (no atomics: two launches are bitwise
//   equal, as a graph replay and the eager step it was captured from must
//   be).  Ragged N, and m or k past M, arrive as TMA's zero fill.
//
// On the card, chip_smoke.py's right_products_phase holds it to the plain
// 3-pass product and to float64; probes/tril_right3.py times it against
// another checkout's design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tril_right3_plan.cuh"
#include "tril_tma.cuh"

namespace k5 {

using namespace tril_right3_plan;

constexpr int PRODUCERS = 128;            // a warpgroup; one thread loads
constexpr int THREADS = CONSUMERS + SPLITTERS + PRODUCERS;
constexpr int A_BOX = BM * 32 * 4;        // A: 128 rows x 32 floats, 16 KB
constexpr int A_BOXES = BK / 32;
constexpr int L_BYTES = BK * BN * 4;      // L: BK x 128 floats, then hi, lo
constexpr int HALF = BK * 128;            // one BK x 64 bf16 box
constexpr int STEPS = BK / 16;            // 16-deep steps of a stage
constexpr int STAGE_BYTES = A_BOXES * A_BOX + L_BYTES;
constexpr int STAGES = 196608 / STAGE_BYTES;  // ring depth: 192 KB
constexpr int BARRIERS = 3 * STAGES;      // full, split, empty
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BARRIERS * 8 + 1024;
static_assert(STEPS % 2 == 0, "fragment buffers alternate within a stage");
// setmaxnreg: the producer warpgroup keeps PRODUCER_REGS, the splitter
// SPLIT_REGS (its float4s and addresses), and the consumers take the rest
// of the block's (ptxas's cap, 65536 / THREADS)
constexpr int BLOCK_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int SPLIT_REGS = SPLIT_VEC * 4 + 48;
constexpr int CONSUMER_REGS =
    (BLOCK_REGS * THREADS - SPLIT_REGS * SPLITTERS -
     PRODUCER_REGS * PRODUCERS) / CONSUMERS / 8 * 8;
constexpr int SPLIT_BAR = 1;     // named barrier of the splitter warpgroup
constexpr int CONSUMER_BAR = 2;  // and of the consumers (split tiles)
constexpr long long FLAG_SPINS = 1ll << 24;

// A split tile's "partial written" flags: raised by the block of its
// longer part, lowered again by the block that adds it, so every launch
// starts and ends with them down.
__device__ uint32_t partial_ready[MAX_SPLIT];

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

// wgmma descriptor of a 128-byte-swizzled MN-major tile at p (1024-byte
// aligned): K rows of 64 bf16 (128 bytes) of N, 8-row groups 1024 bytes
// apart (SBO), the second 64 N columns HALF bytes on (LBO).  Adding 128
// moves it 16 rows deeper along K.
__device__ __forceinline__ uint64_t mn_desc(const void* p) {
  return (uint64_t)((tril_tma::smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(HALF >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128 over the warpgroup) += a (64 x 16, bf16 registers) b, with b
// the MN-major 16 x 128 bf16 tile named by desc (wgmma transposes it).
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t* a,
                                      uint64_t desc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One arrival on `bar` where `pred` holds, as a predicated instruction: a
// branch around it, with products still running, would make ptxas wait
// for them (it serializes wgmma across divergent code).
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

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The TMA loads of the cursor's stage into the ring slot at st, once the
// consumers have released the slot's previous use.
__device__ __forceinline__ void load_stage(const Cursor& c, uint8_t* st,
                                           uint64_t* full, uint64_t* empty,
                                           const tril_tma::Ring& ring,
                                           const CUtensorMap* mapA,
                                           const CUtensorMap* mapL) {
  tril_tma::mbar_wait(empty + ring.slot, ring.phase ^ 1);
  uint64_t* bar = full + ring.slot;
  const int m0 = c.w.j * BN + c.s * BK;
  tril_tma::mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
  for (int b = 0; b < A_BOXES; ++b) {
    tril_tma::tma_load_3d(st + b * A_BOX, mapA, bar, m0 + 32 * b,
                          c.w.rt * BM, c.w.q);
  }
  tril_tma::tma_load_3d(st + A_BOXES * A_BOX, mapL, bar, c.w.j * BN, m0,
                        c.w.q);
}

}  // namespace k5

__global__ void __launch_bounds__(k5::THREADS, 1)
tril_right3_tma_kernel(const __grid_constant__ CUtensorMap mapA,
                       const __grid_constant__ CUtensorMap mapL,
                       float* __restrict__ out, float* __restrict__ partials,
                       int N, int M,
                       const __grid_constant__ tril_right3_plan::Plan plan) {
  using namespace k5;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on it.
  // Pointer arithmetic on smem_raw, not a round trip through an integer,
  // keeps the stages in the shared address space (shared loads, LDS).
  uint8_t* smem =
      smem_raw + ((1024 - (tril_tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* split = full + STAGES;
  uint64_t* empty = split + STAGES;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tril_tma::mbar_init(full + s, 1);
      tril_tma::mbar_init(split + s, SPLITTERS / 32);
      tril_tma::mbar_init(empty + s, CONSUMERS / 32);
    }
    tril_tma::fence_barrier_init();
  }
  __syncthreads();

  const int units = plan.units();
  if (tid >= CONSUMERS + SPLITTERS) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (tid != CONSUMERS + SPLITTERS) return;
    tril_tma::Ring ring;
    for (Cursor c(plan, blockIdx.x, gridDim.x); !c.done; c.next()) {
      load_stage(c, smem + ring.slot * STAGE_BYTES, full, empty, ring, &mapA,
                 &mapL);
      ring.advance(STAGES);
    }
    return;
  }
  if (tid >= CONSUMERS) {  // the splitter
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SPLIT_REGS)
                 : "memory");
    const int t = tid - CONSUMERS;
    tril_tma::Ring ring;
    for (int turn = 0;; ++turn) {
      const int u = plan.index(turn, blockIdx.x, gridDim.x);
      if (u >= units) break;
      for (int part = 0; part < plan.tiles_in(u); ++part) {
        const Work w = plan.work(u, part);
        for (int s = w.s0; s < w.s1; ++s) {
          tril_tma::mbar_wait(full + ring.slot, ring.phase);
          uint8_t* lt = smem + ring.slot * STAGE_BYTES + A_BOXES * A_BOX;
          float4 x[SPLIT_VEC];
#pragma unroll
          for (int i = 0; i < SPLIT_VEC; ++i) {
            x[i] = *reinterpret_cast<const float4*>(
                lt + split_row(t, i) * 512 + split_c4(t, i) * 16);
          }
          named_barrier(SPLIT_BAR, SPLITTERS);  // every float read
          if (straddles(s)) {
#pragma unroll
            for (int i = 0; i < SPLIT_VEC; ++i) {
              const int m = s * BK + split_row(t, i), k = 4 * split_c4(t, i);
              if (!keep(m, k + 0)) x[i].x = 0.0f;
              if (!keep(m, k + 1)) x[i].y = 0.0f;
              if (!keep(m, k + 2)) x[i].z = 0.0f;
              if (!keep(m, k + 3)) x[i].w = 0.0f;
            }
          }
#pragma unroll
          for (int i = 0; i < SPLIT_VEC; ++i) {
            uint32_t h01, h23, l01, l23;
            split2(make_float2(x[i].x, x[i].y), h01, l01);
            split2(make_float2(x[i].z, x[i].w), h23, l23);
            const int off = split_offset(split_row(t, i), split_c4(t, i));
            *reinterpret_cast<uint2*>(lt + off) = make_uint2(h01, h23);
            *reinterpret_cast<uint2*>(lt + 2 * HALF + off) =
                make_uint2(l01, l23);
          }
          // the generic-proxy writes, before wgmma reads them (async proxy)
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) tril_tma::mbar_arrive(split + ring.slot);
          ring.advance(STAGES);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  // the warp's 16 rows of its warpgroup's 64: fragment rows r0 and r0 + 8
  const int t4 = lane % 4;
  const int r0 = acc_row(tid, 0);
  tril_tma::Ring ring;
  for (int turn = 0;; ++turn) {
    const int u = plan.index(turn, blockIdx.x, gridDim.x);
    if (u >= units) break;
    for (int part = 0; part < plan.tiles_in(u); ++part) {
      const Work w = plan.work(u, part);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      fence_acc(acc);
      uint32_t frag[2][8];  // a step's ahi[4], alo[4]; two steps in flight
      for (int s = w.s0; s < w.s1; ++s) {
        tril_tma::mbar_wait(full + ring.slot, ring.phase);
        tril_tma::mbar_wait(split + ring.slot, ring.phase);
        const uint8_t* st = smem + ring.slot * STAGE_BYTES;
        const uint64_t dhi = mn_desc(st + A_BOXES * A_BOX);
        const uint64_t dlo = mn_desc(st + A_BOXES * A_BOX + 2 * HALF);
        // the slot of the stage before, released once this stage's first
        // products are issued and every product of that one is done
        uint64_t* before = empty + (ring.slot + STAGES - 1) % STAGES;
#pragma unroll
        for (int kk = 0; kk < STEPS; ++kk) {  // 16-deep steps: A box kk / 2
          uint32_t* ahi = frag[kk & 1];
          uint32_t* alo = frag[kk & 1] + 4;
          const uint8_t* box = st + (kk >> 1) * A_BOX;
          const int c = (kk & 1) * 16 + 2 * t4;
          const float2 x0 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0, c));
          const float2 x1 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0 + 8, c));
          const float2 x2 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0, c + 8));
          const float2 x3 = *reinterpret_cast<const float2*>(
              box + tril_tma::swz_f32(r0 + 8, c + 8));
          split2(x0, ahi[0], alo[0]);
          split2(x1, ahi[1], alo[1]);
          split2(x2, ahi[2], alo[2]);
          split2(x3, ahi[3], alo[3]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          wgmma(acc, alo, dhi + 128 * kk);  // the small terms first
          wgmma(acc, ahi, dlo + 128 * kk);
          wgmma(acc, ahi, dhi + 128 * kk);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the step before is done: its fragment registers are free again
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (kk == 0) arrive_if(before, lane == 0 && s > w.s0);
        }
        ring.advance(STAGES);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      arrive_if(empty + (ring.slot + STAGES - 1) % STAGES, lane == 0);

      if (w.role == WRITES_PARTIAL) {
        float2* part = reinterpret_cast<float2*>(partials);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          part[partial_at(w.slot, x, tid)] =
              make_float2(acc[2 * x], acc[2 * x + 1]);
        }
        __threadfence();
        named_barrier(CONSUMER_BAR, CONSUMERS);
        if (tid == 0) {
          asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(
                           partial_ready + w.slot),
                       "r"(1u)
                       : "memory");
        }
        continue;
      }
      if (w.role == ADDS_PARTIAL) {
        if (tid == 0) {
          for (long long spins = 0;; ++spins) {
            uint32_t ready;
            asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                         : "=r"(ready)
                         : "l"(partial_ready + w.slot)
                         : "memory");
            if (ready) break;
            if (spins > FLAG_SPINS) __trap();
            __nanosleep(64);
          }
          partial_ready[w.slot] = 0u;  // read by the next launch only
        }
        named_barrier(CONSUMER_BAR, CONSUMERS);
        const float2* part = reinterpret_cast<const float2*>(partials);
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const float2 p = __ldcg(part + partial_at(w.slot, x, tid));
          acc[2 * x] += p.x;
          acc[2 * x + 1] += p.y;
        }
      }
      // accumulator 4 j + 2 h + e: row r0 + 8 h, column 8 j + 2 t4 + e
      float* outq = out + (size_t)w.q * N * M;
      const int n0 = w.rt * BM, k0 = w.j * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + acc_row(tid, 2 * h);
        if (n >= N) continue;
        float* row = outq + (size_t)n * M;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = k0 + acc_col(tid, 4 * j);
          if (k < M) {  // M % 4 == 0, k even: k + 1 < M too
            *reinterpret_cast<float2*>(row + k) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// Plain C entry points, bound with ctypes.

namespace k5 {

// The plan of the last shape launched: make_plan walks the schedule once
// per candidate split, so a training loop's repeated shapes reuse it.
inline Plan plan_for(int Q, int N, int M) {
  static int key[4] = {0, 0, 0, 0};
  static Plan plan;
  const int sms = tril_tma::sm_count();
  if (key[0] != Q || key[1] != N || key[2] != M || key[3] != sms) {
    plan = make_plan(Q, N, M, sms);
    key[0] = Q;
    key[1] = N;
    key[2] = M;
    key[3] = sms;
  }
  return plan;
}

}  // namespace k5

// Floats of partial-sum scratch a launch at (Q, N, M) needs: one 128 x 128
// tile for each split tile, 0 where the plan splits none.
extern "C" long long hetmogp_tril_right3_partials(int Q, int N, int M) {
  if (Q <= 0 || N <= 0 || M <= 0) return 0;
  const tril_right3_plan::Plan p = k5::plan_for(Q, N, M);
  return p.split ? (long long)p.Q * p.R * tril_right3_plan::BM *
                       tril_right3_plan::BN
                 : 0;
}

// The schedule at (Q, N, M) on `sms` SMs: blocks, the busiest block's
// stages, all stages, and the split (0: none).  For the probe.
extern "C" int hetmogp_tril_right3_schedule(int Q, int N, int M, int sms,
                                            long long* out4) {
  using namespace tril_right3_plan;
  if (Q <= 0 || N <= 0 || M <= 0 || sms <= 0) return -1;
  const Plan p = make_plan(Q, N, M, sms);
  long long total = 0;
  for (int b = 0; b < blocks(p, sms); ++b) total += block_stages(p, b, sms);
  out4[0] = blocks(p, sms);
  out4[1] = busiest(p, sms);
  out4[2] = total;
  out4[3] = p.split;
  return 0;
}

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success), or a negative CUresult when a tensor
// map cannot be encoded.  The caller checks shapes, dtype, contiguity and
// device; `partials` holds hetmogp_tril_right3_partials(Q, N, M) floats
// (may be null where that is 0).  Launches of one process on one device
// must not overlap: they share the split tiles' flags.
extern "C" int hetmogp_tril_right3_f32(const float* A, const float* L,
                                       float* out, float* partials, int Q,
                                       int N, int M, cudaStream_t stream) {
  using namespace k5;
  if (Q <= 0 || N <= 0 || M <= 0 || M % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long R = (N + BM - 1) / BM;
  const long long C = (M + BN - 1) / BN;
  if (Q * R * (C + 1) > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for(Q, N, M);
  if (plan.split && partials == nullptr) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tril_right3_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // setmaxnreg.inc waits for registers the block holds: refuse a build
  // that gives it too few to hand over, rather than hang
  cudaFuncAttributes attr;
  const cudaError_t attr_err =
      cudaFuncGetAttributes(&attr, tril_right3_tma_kernel);
  if (attr_err != cudaSuccess) return (int)attr_err;
  if (attr.numRegs * THREADS <
      SPLIT_REGS * SPLITTERS + CONSUMER_REGS * CONSUMERS) {
    return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap mapA, mapL;
  int err = tril_tma::encode_3d(&mapA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, A, M,
                                N, Q, 4ull * M, 4ull * N * M, 32, BM);
  if (err != 0) return err;
  err = tril_tma::encode_3d(&mapL, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, L, M, M,
                            Q, 4ull * M, 4ull * M * M, BN, BK,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  tril_right3_tma_kernel<<<blocks(plan, tril_tma::sm_count()), THREADS,
                           SMEM_BYTES, stream>>>(mapA, mapL, out, partials, N,
                                                 M, plan);
  return (int)cudaGetLastError();
}
