// Kernel 5's schedule (tril_right3_kernel.cu): which output tiles, or
// which part of a tile's reduction, each persistent block takes turn by
// turn, in which order its stages reach the ring, and where the two
// parts of a split tile meet.  Plain C++ behind K5_HD, which is
// __host__ __device__ under nvcc and empty under a host compiler, so that
// the CPU tests walk the schedule the kernel runs
// (tril_right3_plan_host.cpp, tests/test_torch_tril_right3_plan.py).  No
// CUDA header is included here.
//
// A tile is BM rows n by BN columns k of out = A tril(L); column tile j
// (k0 = j BN) reduces over m from k0 to M in stages of BK, so column tile
// 0 is the longest and column tile C - 1 the shortest.  Blocks walk work
// units in a snake (block b takes unit b on its first turn, 2G - 1 - b on
// its second, ...).
//
// * Paired, where there are at least two pairs for every SM: a unit is the
//   column tiles p and C - 1 - p of one row tile (one tile where they
//   coincide), so every unit has the same C + 1 BN-wide blocks of
//   reduction and the blocks of a turn share their A rows through L2 (as
//   tril_tiles.cuh's Tiles, which kernels A, 3 and 4 walk).
// * Unpaired otherwise: a unit is one tile, heaviest first.  A short
//   launch then ends on its heaviest tiles: at the VM shape (4, 768, 1024)
//   on 132 SMs the 24 tiles of column tile 0 take 16 stages where a block
//   averages 13.1.  So make_plan may split column tile 0's reduction into
//   a head, stages [0, split), and a tail, [split, S0), each its own unit,
//   sorted among the tiles by length: the longer part (the tail where they
//   are equal) writes its float32 partial sum to scratch and raises its
//   flag; the shorter, which the snake reaches on the same turn or later,
//   waits for the flag and stores partial + its own sum.  A sum of two
//   float32 values does not depend on their order, every output is
//   computed the same way in every launch, and no atomic is used: two
//   launches are bitwise equal.  split is chosen on the host from the
//   shape and the SM count alone, the one that most lowers the busiest
//   block's stages (none where nothing lowers them).

#pragma once

#if defined(__CUDACC__)
#define K5_HD __host__ __device__ __forceinline__
#else
#define K5_HD inline
#endif

namespace tril_right3_plan {

constexpr int BM = 128;  // rows n of a tile: two consumer warpgroups of 64
constexpr int BN = 128;  // columns k of a tile
constexpr int BK = 64;   // reduction depth m of a stage
// split tiles a launch may have: its flags (tril_right3_kernel.cu)
constexpr int MAX_SPLIT = 1024;

constexpr int CONSUMERS = 256;  // two warpgroups, 64 rows each
constexpr int SPLITTERS = 128;  // one warpgroup

// stages of column tile j's reduction, m from j BN to M
K5_HD int stages(int M, int j) { return (M - j * BN + BK - 1) / BK; }

// The stages of a tile whose m can lie below its columns k: the splitter
// zeroes tril(L)[m, k] for m < k there (m and k relative to the tile's
// k0).
K5_HD bool straddles(int s) { return s * BK < BN; }
K5_HD bool keep(int m, int k) { return m >= k; }

// The splitter's thread t (of SPLITTERS) takes float4 i (of SPLIT_VEC)
// of a stage's BK x 128 float32 L tile: row m, columns 4 c4 .. 4 c4 + 3.
// A warp reads one 512-byte row.
constexpr int SPLIT_VEC = BK * BN / 4 / SPLITTERS;
K5_HD int split_row(int t, int i) { return (t + SPLITTERS * i) >> 5; }
K5_HD int split_c4(int t, int i) { return (t + SPLITTERS * i) & 31; }
// Byte offset of bf16 element (m, 4 c4) of the hi (or lo) tile: wgmma's
// MN-major operand, two boxes of BK rows by 64 columns, 128 BK bytes
// apart, of 128-byte rows whose 16-byte chunk c sits at c ^ (m % 8).  Four
// elements are 8 bytes, half a chunk.
K5_HD int split_offset(int m, int c4) {
  return (c4 >> 4) * (BK * 128) + m * 128 +
         ((((c4 & 15) >> 1) ^ (m & 7)) << 4) + ((c4 & 1) << 3);
}

// Consumer thread tid's accumulator e (wgmma's m64n128 float32 layout):
// its row and column of the tile.
K5_HD int acc_row(int tid, int e) {
  const int warp = tid / 32, lane = tid % 32;
  return (warp / 4) * 64 + (warp % 4) * 16 + lane / 4 + 8 * ((e >> 1) & 1);
}
K5_HD int acc_col(int tid, int e) {
  return 8 * (e >> 2) + 2 * (tid % 4) + (e & 1);
}
// The float2 of a split tile's partial that holds accumulators 2 x and
// 2 x + 1 of consumer thread tid: a warp's 32 float2 are contiguous.
K5_HD long long partial_at(int slot, int x, int tid) {
  return ((long long)slot * 32 + x) * CONSUMERS + tid;
}

// What a unit's block does with its sum.
enum Role { WHOLE = 0, WRITES_PARTIAL = 1, ADDS_PARTIAL = 2 };

// One tile, or one part of a split tile: latent q, row tile rt, column
// tile j (k0 = j BN), stages [s0, s1) of its reduction (m from
// k0 + s0 BK), the role, and the split tile's partial and flag (q R + rt).
struct Work {
  int q, rt, j, s0, s1, role, slot;
};

struct Plan {
  int Q, R, C, M;  // latents, row tiles, column tiles, depth
  int paired;
  int split;  // 0, or column tile 0's head: stages [0, split)

  K5_HD int pairs() const { return (C + 1) / 2; }
  K5_HD int classes() const { return split ? C + 1 : C; }
  K5_HD int units() const { return Q * R * (paired ? pairs() : classes()); }
  // unit index of block b (of G) on its turn-th turn: a snake over blocks
  K5_HD int index(int turn, int b, int G) const {
    return turn * G + ((turn & 1) ? G - 1 - b : b);
  }
  K5_HD int tiles_in(int u) const {
    return paired && 2 * (u % pairs()) != C - 1 ? 2 : 1;
  }
  K5_HD int head() const { return split; }
  K5_HD int tail() const { return stages(M, 0) - split; }
  // column tiles j >= 1 of at least s stages: M - j BN > (s - 1) BK
  K5_HD int tiles_at_least(int s) const {
    const int lim = M - (s - 1) * BK;
    const int n = lim <= 0 ? 0 : (lim + BN - 1) / BN - 1;
    return n > C - 1 ? C - 1 : n;
  }
  // the i-th tile of unit u
  K5_HD Work work(int u, int i) const {
    Work w;
    w.role = WHOLE;
    w.slot = 0;
    int rest;
    if (paired) {
      const int p = u % pairs();
      w.j = i == 0 ? p : C - 1 - p;
      rest = u / pairs();
    } else {
      const int c = u / (Q * R);  // the unit's class, heaviest first
      rest = u % (Q * R);
      w.j = c;
      if (split) {
        // the classes: column tiles 1 .. C - 1 and the two parts, by
        // length (a tile before a part of its length); the longer part
        // sits at class p1, the shorter at p2 > p1
        const bool tail_first = tail() >= head();
        const int p1 = tiles_at_least(tail_first ? tail() : head());
        const int p2 = tiles_at_least(tail_first ? head() : tail()) + 1;
        if (c == p1 || c == p2) {
          const bool is_tail = (c == p1) == tail_first;
          w.j = 0;
          w.s0 = is_tail ? split : 0;
          w.s1 = is_tail ? stages(M, 0) : split;
          w.role = c == p1 ? WRITES_PARTIAL : ADDS_PARTIAL;
          w.slot = rest;
          w.q = rest / R;
          w.rt = rest % R;
          return w;
        }
        w.j = c + 1 - (c > p1 ? 1 : 0) - (c > p2 ? 1 : 0);
      }
    }
    w.q = rest / R;
    w.rt = rest % R;
    w.s0 = 0;
    w.s1 = stages(M, w.j);
    return w;
  }
};

// The stages of block b's units in the order they pass through the ring,
// as one cursor: the loads walk it, STAGES - 1 stages ahead of the
// splitter and the consumers, which walk the same order as loops over
// turns, a unit's tiles and a tile's stages.
struct Cursor {
  const Plan& plan;
  int b, G, turn, i, u, s;
  Work w;
  bool done;
  K5_HD Cursor(const Plan& p, int block, int blocks)
      : plan(p), b(block), G(blocks), turn(0), i(0), s(0), done(false) {
    u = plan.index(0, b, G);
    start();
  }
  K5_HD void start() {
    done = u >= plan.units();
    if (!done) {
      w = plan.work(u, i);
      s = w.s0;
    }
  }
  // the unit's first stage: where a tile's sum starts
  K5_HD bool first() const { return s == w.s0; }
  K5_HD void next() {
    if (++s < w.s1) return;
    if (++i == plan.tiles_in(u)) {
      i = 0;
      u = plan.index(++turn, b, G);
    }
    start();
  }
};

// Persistent grid size: one block per SM, at most one per work unit.
K5_HD int blocks(const Plan& p, int sms) {
  return p.units() < sms ? p.units() : sms;
}

// Stages block b runs in a launch.
inline int block_stages(const Plan& p, int b, int sms) {
  const int G = blocks(p, sms);
  int n = 0;
  for (int turn = 0;; ++turn) {
    const int u = p.index(turn, b, G);
    if (u >= p.units()) return n;
    for (int i = 0; i < p.tiles_in(u); ++i) {
      const Work w = p.work(u, i);
      n += w.s1 - w.s0;
    }
  }
}

// The busiest block's stages.
inline int busiest(const Plan& p, int sms) {
  int most = 0;
  for (int b = 0; b < blocks(p, sms); ++b) {
    const int n = block_stages(p, b, sms);
    most = n > most ? n : most;
  }
  return most;
}

// The schedule of Q latents of N x M outputs on `sms` SMs: paired where
// there are at least two pairs for every SM, else single tiles with
// column tile 0 split where that lowers the busiest block's stages.
inline Plan make_plan(int Q, int N, int M, int sms) {
  Plan p{Q, (N + BM - 1) / BM, (M + BN - 1) / BN, M, 0, 0};
  p.paired = (long long)Q * p.R * p.pairs() >= 2LL * sms;
  if (p.paired || (long long)Q * p.R > MAX_SPLIT) return p;
  int best = busiest(p, sms);
  Plan trial = p;
  for (int s = 1; s < stages(M, 0); ++s) {
    trial.split = s;
    const int n = busiest(trial, sms);
    if (n < best) {
      best = n;
      p.split = s;
    }
  }
  return p;
}

}  // namespace tril_right3_plan
