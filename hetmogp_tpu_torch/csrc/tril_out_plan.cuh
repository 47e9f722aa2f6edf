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
//   block, P = min(G / rem, S).  Every part writes its float32 partial
//   sum to its own scratch slot, in the tile's row-major layout, raises
//   its flag and waits for the tile's P flags; then part p reduces its
//   own 1/P of the tile (float4s [p V / P, (p + 1) V / P) of its V =
//   BT BT / 4): for each element it loads the P partials, adds them in
//   part order, ((partial_0 + partial_1) + ...) + partial_{P-1}, and
//   stores the sum with the diagonal's mask (the same float4s of the
//   mirror tile get their zeros from the part, or in the three-pass
//   design from the producer's idle warps).  The order is fixed by the
//   shape and the SM count alone, no atomic touches a value, and every
//   block of the grid is resident at once (G <= the resident blocks), so
//   two launches are bitwise equal and the waits end.
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
constexpr int TILE_VEC = BT * BT / 4;  // float4s of a tile

// The design's depth of a stage: BK rows n.  The FFMA route (f32) and
// the three-pass wgmma route both take 32.
constexpr int BK_F32 = 32;
constexpr int BK_3PASS = 32;

// What a unit's block does with its sum: store it, or, as one part of a
// split tile, write it to its slot and reduce its share of the tile.
enum Role { WHOLE = 0, PART = 1 };

// One tile, or one part of a split tile: latent q, row tile i (m1 from
// i BT), column tile j (m2 from j BT), stages [s0, s1) of its reduction,
// the role, the part p of `parts`, and the tile's first slot `base`: part
// k of the tile writes slot base + k, and every part reads all P.
struct Work {
  int q, i, j, s0, s1, role, part, parts, base;
  // this part's own slot
  K8_HD int slot() const { return base + part; }
  // the float4s [v0, v1) of the tile (row-major, 32 a row) it reduces
  K8_HD int v0() const { return part * TILE_VEC / parts; }
  K8_HD int v1() const { return (part + 1) * TILE_VEC / parts; }
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
  int G;        // persistent blocks, at most the resident ones
  int F;        // turns of whole tiles
  int rem;      // tiles of the last turn
  int P;        // parts each of those (1: whole)

  K8_HD int per_latent() const { return C * (C + 1) / 2; }
  K8_HD int tiles() const { return Q * per_latent(); }
  // turns block b takes: F, and one more where it holds a part (or, with
  // P = 1, a whole tile) of the last turn
  K8_HD int turns(int b) const { return F + (b < rem * P ? 1 : 0); }
  // split partials a launch writes, one a part, and their flags
  K8_HD int slots() const { return P > 1 ? rem * P : 0; }
  K8_HD Work work(int b, int turn) const {
    Work w;
    int t;
    w.role = WHOLE;
    w.part = 0;
    w.parts = 1;
    w.base = 0;
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
        w.role = PART;
        w.part = p;
        w.parts = P;
        w.base = r * P;
      }
    }
    w.q = t / per_latent();
    lower_tile(t % per_latent(), w.i, w.j);
    return w;
  }
};

// The schedule of Q latents of M x M outputs over N rows in stages of BK
// for `resident` blocks that the card holds at once (one a block an SM:
// the SM count).  The split tiles' waits end only if every block of the
// grid is resident, so G never exceeds it.
inline Plan make_plan(int Q, int N, int M, int BK, int resident) {
  Plan p;
  p.Q = Q;
  p.C = (M + BT - 1) / BT;
  p.S = (N + BK - 1) / BK;
  const int T = p.tiles();
  p.G = T < resident ? T : resident;
  p.F = T / p.G;
  p.rem = T - p.F * p.G;
  p.P = 1;
  if (p.rem > 0) {
    int parts = p.G / p.rem;
    if (parts > p.S) parts = p.S;
    if (parts < 1) parts = 1;
    while (parts > 1 && p.rem * parts > MAX_SLOTS) --parts;
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

// The most partial float4s one block reads in its fix-up: P partials of
// its share of a split tile.
inline long long most_fixup_reads(const Plan& p) {
  long long most = 0;
  for (int b = 0; b < p.G; ++b) {
    for (int turn = 0; turn < p.turns(b); ++turn) {
      const Work w = p.work(b, turn);
      const long long n =
          w.role == PART ? (long long)w.parts * (w.v1() - w.v0()) : 0;
      most = n > most ? n : most;
    }
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

// A split tile's slot, as floats: element (r, c) of slot k at
// slot_at(k) + r BT + c, the tile's row-major layout.
K8_HD long long slot_at(int k) { return (long long)k * BT * BT; }

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
// A's stage lands as four 128-byte-swizzled boxes of 32 columns m1 by
// BK rows n (tril_tma.cuh's layout: the 16-byte chunk c of row n at
// c ^ (n % 8)), box b holding m1 in [32 b, 32 b + 32).  At 16-deep step kk
// consumer thread tid reads wgmma's A fragment of its warp's 16 rows m1
// there, as float32, and splits it in registers: element e (of 8; register
// e / 2 of the fragment's 4, half e % 2) is A[n][m1] at
//   m1 = 64 (warp / 4) + 16 (warp % 4) + lane / 4 + 8 ((e / 2) & 1),
//   n  = 16 kk + 2 (lane % 4) + e % 2 + 8 (e / 4).
// A warp's 32 loads of one element fall in 32 banks.
K8_HD int afrag_m1(int tid, int e) {
  const int warp = tid / 32, lane = tid % 32;
  return 64 * (warp / 4) + 16 * (warp % 4) + lane / 4 + 8 * ((e >> 1) & 1);
}
K8_HD int afrag_n(int tid, int kk, int e) {
  return 16 * kk + 2 * (tid % 4) + (e & 1) + 8 * (e >> 2);
}
// its byte offset in the stage's A boxes
K8_HD int afrag_offset(int tid, int kk, int e) {
  const int m1 = afrag_m1(tid, e), n = afrag_n(tid, kk, e), c = m1 & 31;
  return (m1 >> 5) * (BK_3PASS * 128) + n * 128 +
         ((((c >> 2) ^ n) & 7) << 4) + ((c & 3) << 2);
}
// The same as afrag_offset(tid, 0, e % 4) plus a constant: n % 8, and so
// the swizzle, does not depend on kk or e / 4, so a thread keeps four
// offsets and adds 16 kk + 8 (e / 4) rows.
K8_HD int afrag_step(int kk, int e) { return (16 * kk + 8 * (e >> 2)) * 128; }

// The splitter warpgroup: thread t (of SPLITTERS = 128) takes float4 i (of
// SPLIT_VEC) of the stage's BK x BT float32 tile of B, as it landed: row
// n, columns 4 c4 .. 4 c4 + 3; a warp reads one 512-byte row.  It writes
// hi and lo into the split ring's slot as wgmma's MN-major operand: two
// boxes of BK rows by 64 columns, BK 128 bytes apart, of 128-byte rows
// whose 16-byte chunk c sits at c ^ (n % 8) (kernel 5's layout,
// tril_right3_plan.cuh).
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
