// Kernel 8's schedule and index arithmetic (tril_out_kernel.cu, the two
// TMA-fed designs): which lower output tile, or which part of a tile's
// reduction, each persistent block takes turn by turn, in which order its
// stages reach the ring, where the parts of a split tile meet, and which
// outputs each thread holds.  Plain C++ behind K8_HD, which is
// __host__ __device__ under nvcc and empty under a host compiler, so that
// the CPU tests walk the schedule the kernel runs (tril_out_plan_host.cpp,
// tests/test_torch_tril_out_plan.py).  No CUDA header is included here.
//
// out[q, m1, m2] = sum_n A[q, n, m1] B[q, n, m2] for m1 >= m2 (tril(A^T B)).
// A tile is BT rows m1 by BT columns m2; only the C (C + 1) / 2 lower tiles
// i >= j of each latent are formed, each over the whole reduction n in
// [0, N), S stages of BK rows.  Every tile is the same work, so the
// schedule's only trouble is the last wave: at M = 1024 a latent has 36
// lower tiles, Q = 4 gives 144, and 144 tiles on 132 SMs are 1.09 waves.
//
// * F whole turns: G = min(SMs, tiles) persistent blocks take tile
//   turn G + b on turn `turn`; the blocks of a turn start together and run
//   the same n stages at about the same time, so the A and B rows that the
//   tiles of one latent share are read from device memory about once and
//   from L2 after.
// * One last turn for the rem = tiles - F G tiles left: each is cut into P
//   parts of its reduction (stages [p S / P, (p + 1) S / P)), one part a
//   block, P = min(G / rem, S).  The parts 0 .. P - 2 each write their
//   float32 partial sum to scratch and raise its flag; part P - 1 waits
//   for the flags and stores ((partial_0 + partial_1) + ...) + its own
//   sum, in increasing part order.  The order is fixed by the shape and
//   the SM count alone, no atomic is used, and every block of the grid is
//   resident at once (G <= SMs), so two launches are bitwise equal and
//   the waits end.
//
// Tiles above the diagonal are never computed: the block that stores the
// lower tile (i, j), i > j, writes zeros over its mirror (j, i), and a
// diagonal tile zeroes its own m1 < m2 in the epilogue.

#pragma once

#if defined(__CUDACC__)
#define K8_HD __host__ __device__ __forceinline__
#else
#define K8_HD inline
#endif

namespace tril_out_plan {

constexpr int BT = 128;          // rows m1 and columns m2 of a tile
constexpr int CONSUMERS = 256;   // threads that hold the tile's sums
constexpr int MAX_SLOTS = 1024;  // split partials a launch may have: flags

// The design's depth of a stage: BK rows n.  The FFMA route (f32) takes
// 32, the three-pass wgmma route 64.
constexpr int BK_F32 = 32;
constexpr int BK_3PASS = 64;

// What a unit's block does with its sum.
enum Role { WHOLE = 0, WRITES_PARTIAL = 1, ADDS_PARTIAL = 2 };

// One tile, or one part of a split tile: latent q, row tile i (m1 from
// i BT), column tile j (m2 from j BT), stages [s0, s1) of its reduction,
// the role, and the slot: the partial a writer writes, or the first of the
// P - 1 partials (slot .. slot + P - 2, in part order) an adder adds.
struct Work {
  int q, i, j, s0, s1, role, slot, parts;
};

// The lower tile of index l (of C (C + 1) / 2) of a latent, row by row:
// l = i (i + 1) / 2 + j, j <= i.
K8_HD void lower_tile(int l, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= l) ++i;
  j = l - i * (i + 1) / 2;
}

struct Plan {
  int Q, C, S;  // latents, tiles along M, stages of a tile's reduction
  int G;        // persistent blocks
  int F;        // turns of whole tiles
  int rem;      // tiles of the last turn
  int P;        // parts each of those (1: whole)

  K8_HD int per_latent() const { return C * (C + 1) / 2; }
  K8_HD int tiles() const { return Q * per_latent(); }
  // turns block b takes: F, and one more where it holds a part (or, with
  // P = 1, a whole tile) of the last turn
  K8_HD int turns(int b) const { return F + (b < rem * P ? 1 : 0); }
  // split partials a launch writes
  K8_HD int slots() const { return P > 1 ? rem * (P - 1) : 0; }
  K8_HD Work work(int b, int turn) const {
    Work w;
    int t;
    w.role = WHOLE;
    w.slot = 0;
    w.parts = 1;
    w.s0 = 0;
    w.s1 = S;
    if (turn < F) {
      t = turn * G + b;
    } else {
      const int r = b / P, p = b % P;
      t = F * G + r;
      if (P > 1) {
        w.s0 = p * S / P;
        w.s1 = (p + 1) * S / P;
        w.parts = P;
        w.role = p == P - 1 ? ADDS_PARTIAL : WRITES_PARTIAL;
        w.slot = r * (P - 1) + (p == P - 1 ? 0 : p);
      }
    }
    w.q = t / per_latent();
    lower_tile(t % per_latent(), w.i, w.j);
    return w;
  }
};

// The schedule of Q latents of M x M outputs over N rows in stages of BK
// on `sms` SMs.
inline Plan make_plan(int Q, int N, int M, int BK, int sms) {
  Plan p;
  p.Q = Q;
  p.C = (M + BT - 1) / BT;
  p.S = (N + BK - 1) / BK;
  const int T = p.tiles();
  p.G = T < sms ? T : sms;
  p.F = T / p.G;
  p.rem = T - p.F * p.G;
  p.P = 1;
  if (p.rem > 0) {
    int parts = p.G / p.rem;
    if (parts > p.S) parts = p.S;
    if (parts < 1) parts = 1;
    while (parts > 1 && p.rem * (parts - 1) > MAX_SLOTS) --parts;
    p.P = parts;
  }
  return p;
}

// Stages block b runs in a launch.
inline int block_stages(const Plan& p, int b) {
  int n = 0;
  for (int turn = 0; turn < p.turns(b); ++turn) {
    const Work w = p.work(b, turn);
    n += w.s1 - w.s0;
  }
  return n;
}

// The busiest block's stages.
inline int busiest(const Plan& p) {
  int most = 0;
  for (int b = 0; b < p.G; ++b) {
    const int n = block_stages(p, b);
    most = n > most ? n : most;
  }
  return most;
}

// The stages of block b's units in the order they pass through the ring,
// as one cursor: the loads walk it, STAGES - 1 stages ahead of the
// consumers (and of the three-pass route's splitter), which walk the same
// order as loops over turns and a unit's stages.
struct Cursor {
  const Plan& plan;
  int b, turn, s;
  Work w;
  bool done;
  K8_HD Cursor(const Plan& p, int block) : plan(p), b(block), turn(0), s(0) {
    start();
  }
  K8_HD void start() {
    done = turn >= plan.turns(b);
    while (!done) {
      w = plan.work(b, turn);
      s = w.s0;
      if (s < w.s1) return;
      done = ++turn >= plan.turns(b);  // a part without stages
    }
  }
  K8_HD void next() {
    if (++s < w.s1) return;
    ++turn;
    start();
  }
};

// ---- the FFMA route: which outputs a consumer thread holds ----------------
//
// Eight warps hold 64 x 32 warp tiles, 2 x 4; a lane holds 8 rows m1 (two
// float4s of an A row of the stage, 32 apart) by 8 columns m2 (two float4s
// of a B row, 16 apart): each n of a stage is a rank-1 update from four
// 16-byte shared loads, and the eight (four) lanes that read one warp's A
// (B) float4s read 128 (64) contiguous bytes.

K8_HD int f32_row(int tid, int i) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp / 4) * 64 + 4 * (lane / 4) + (i & 3) + 32 * (i >> 2);
}
K8_HD int f32_col(int tid, int j) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp % 4) * 32 + 4 * (lane % 4) + (j & 3) + 16 * (j >> 2);
}
// The float4 of a split tile's partial that holds acc[i][4 h .. 4 h + 3]
// of consumer thread tid (x = 2 i + h): a thread's 16 float4s, a warp's
// float4s contiguous for each x.
K8_HD long long f32_partial_at(int slot, int x, int tid) {
  return ((long long)slot * 16 + x) * CONSUMERS + tid;
}

// ---- the three-pass route: wgmma's m64n128 accumulator ---------------------
//
// Consumer warpgroup g holds rows m1 in [64 g, 64 g + 64); thread tid's
// accumulator e sits at row acc_row, column acc_col of the tile.

K8_HD int acc_row(int tid, int e) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp / 4) * 64 + (warp % 4) * 16 + lane / 4 + 8 * ((e >> 1) & 1);
}
K8_HD int acc_col(int tid, int e) {
  return 8 * (e >> 2) + 2 * (tid % 4) + (e & 1);
}
// The float2 of a split tile's partial that holds accumulators 2 x and
// 2 x + 1 of consumer thread tid.
K8_HD long long acc_partial_at(int slot, int x, int tid) {
  return ((long long)slot * 32 + x) * CONSUMERS + tid;
}

// The splitter's thread t (of SPLITTERS = 128) takes float4 i (of
// SPLIT_VEC) of a stage's BK x BT float32 tile of A or B: row n, columns
// 4 c4 .. 4 c4 + 3; a warp reads one 512-byte row.  It writes hi and lo
// as wgmma's MN-major operand: two boxes of BK rows by 64 columns, BK 128
// bytes apart, of 128-byte rows whose 16-byte chunk c sits at c ^ (n % 8)
// (kernel 5's layout, tril_right3_plan.cuh).
constexpr int SPLITTERS = 128;
constexpr int SPLIT_VEC = BK_3PASS * BT / 4 / SPLITTERS;
K8_HD int split_row(int t, int i) { return (t + SPLITTERS * i) >> 5; }
K8_HD int split_c4(int t, int i) { return (t + SPLITTERS * i) & 31; }
K8_HD int split_offset(int n, int c4) {
  return (c4 >> 4) * (BK_3PASS * 128) + n * 128 +
         ((((c4 & 15) >> 1) ^ (n & 7)) << 4) + ((c4 & 1) << 3);
}

// Whether the stored output (m1, m2) of a lower tile is a value (m1 >= m2)
// or a zero of the diagonal tile's upper half.
K8_HD bool keep(int m1, int m2) { return m1 >= m2; }

}  // namespace tril_out_plan
