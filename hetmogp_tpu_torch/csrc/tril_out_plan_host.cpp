// The host build of kernel 8's schedule and index arithmetic
// (tril_out_plan.cuh), for the CPU tests: walks every block, turn and
// stage of one launch of tril_out_tma_kernel or tril_out3_tma_kernel
// (tril_out_kernel.cu) with the cursor their loads (and the three-pass
// splitter) walk and the turns their consumers walk, replays their
// epilogues' stores, and checks what the kernel computes without running
// it.  tests/test_torch_tril_out_plan.py loads it with ctypes after
// compiling it with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libplan.so tril_out_plan_host.cpp
//
// The CUDA build (ops/_build.py) compiles the *.cu sources only.

#include <stdint.h>

#include <algorithm>
#include <vector>

#include "tril_out_plan.cuh"

using namespace tril_out_plan;

// What the walk counts (`stats`, in this order).
enum Stat {
  TILE_FAULTS,    // lower tiles whose reduction is not stages [0, S) once,
                  // as one whole unit or as P parts of one last turn, or
                  // units outside the lower tiles
  ORDER_FAULTS,   // cursor and consumer turns that disagree, or a
                  // block's stages out of order within a unit
  SPLIT_FAULTS,   // split tiles whose parts are not P consecutive blocks
                  // of the last turn, writers whose slot is not their
                  // tile's base + part, an adder whose slot is not the
                  // base, a slot written twice or out of range
  MAP_FAULTS,     // the thread, partial and splitter maps not one to one
  WRITE_FAULTS,   // outputs not written exactly once, or a value where
                  // m1 < m2, or a zero where m1 >= m2
  BLOCKS,         // persistent blocks of the launch
  WHOLE_TURNS,    // F
  LAST_TILES,     // tiles of the last turn
  PARTS,          // parts each of those
  BUSIEST,        // the busiest block's stages
  TOTAL,          // all blocks' stages
  N_STATS
};

// The maps of one tile, the same in every launch.
static long long map_faults(int three) {
  long long faults = 0;
  std::vector<int> out(BT * BT, 0), part(64 * CONSUMERS, 0);
  for (int tid = 0; tid < CONSUMERS; ++tid) {
    for (int e = 0; e < 64; ++e) {
      const int r = three ? acc_row(tid, e) : f32_row(tid, e / 8);
      const int c = three ? acc_col(tid, e) : f32_col(tid, e % 8);
      if (r < 0 || r >= BT || c < 0 || c >= BT) {
        ++faults;
        continue;
      }
      ++out[r * BT + c];
    }
    // the partials' float4s (FFMA) or float2s (wgmma), in floats
    const int width = three ? 2 : 4, n = 64 / width;
    for (int x = 0; x < n; ++x) {
      const long long p = three ? acc_partial_at(3, x, tid) -
                                      acc_partial_at(3, 0, 0)
                                : f32_partial_at(3, x, tid) -
                                      f32_partial_at(3, 0, 0);
      if (p < 0 || p >= (long long)n * CONSUMERS) {
        ++faults;
        continue;
      }
      for (int k = 0; k < width; ++k) ++part[p * width + k];
    }
    // a stored vector's elements are consecutive columns of one row
    if (!three) {
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j)
          faults += f32_col(tid, j) != f32_col(tid, j & 4) + (j & 3);
    } else {
      for (int e = 1; e < 64; e += 2)
        faults += acc_col(tid, e) != acc_col(tid, e - 1) + 1 ||
                  acc_row(tid, e) != acc_row(tid, e - 1);
    }
  }
  for (int s : out) faults += s != 1;
  for (int s : part) faults += s != 1;
  if (three) {  // the splitter's reads and its bf16 writes
    std::vector<int> seen(BK_3PASS * 32, 0), bytes(BK_3PASS * BT * 2 / 8, 0);
    for (int t = 0; t < SPLITTERS; ++t) {
      for (int i = 0; i < SPLIT_VEC; ++i) {
        const int n = split_row(t, i), c4 = split_c4(t, i);
        if (n < 0 || n >= BK_3PASS || c4 < 0 || c4 >= 32) {
          ++faults;
          continue;
        }
        ++seen[n * 32 + c4];
        const int off = split_offset(n, c4);
        const int box = (4 * c4) / 64, col = (4 * c4) % 64;
        const int want = box * BK_3PASS * 128 + n * 128 +
                         (((col / 8) ^ (n % 8)) * 16) + (col % 8) * 2;
        faults += off != want || off % 8 != 0;
        if (off >= 0 && off < BK_3PASS * BT * 2) ++bytes[off / 8];
      }
    }
    for (int s : seen) faults += s != 1;
    for (int s : bytes) faults += s != 1;
  }
  return faults;
}

// Walks one launch over (Q, N, M) on `sms` SMs of the FFMA design
// (three = 0) or the three-pass one; fills stats[N_STATS] and returns the
// number of faults.
extern "C" long long tril_out_plan_walk(int Q, int N, int M, int three,
                                        int sms, long long* stats) {
  std::fill(stats, stats + N_STATS, 0LL);
  const int BK = three ? BK_3PASS : BK_F32;
  const Plan p = make_plan(Q, N, M, BK, sms);
  stats[BLOCKS] = p.G;
  stats[WHOLE_TURNS] = p.F;
  stats[LAST_TILES] = p.rem;
  stats[PARTS] = p.P;
  stats[BUSIEST] = busiest(p);
  stats[MAP_FAULTS] = map_faults(three);
  if (p.G > sms || p.G < 1 || p.slots() > MAX_SLOTS) ++stats[SPLIT_FAULTS];
  const int C = p.C, T = p.per_latent();
  // per tile: the stages taken; per slot: writes; per output: writes and
  // whether a value was stored
  std::vector<std::vector<int>> taken((size_t)Q * C * C);
  std::vector<int> slot_writes(p.slots() > 0 ? p.slots() : 1, 0);
  std::vector<unsigned char> writes((size_t)Q * M * M, 0);
  std::vector<unsigned char> value((size_t)Q * M * M, 0);
  auto store = [&](int q, int m1, int m2, bool is_value) {
    if (m1 >= M || m2 >= M) return;
    const size_t o = ((size_t)q * M + m1) * M + m2;
    ++writes[o];
    value[o] = is_value;
  };
  for (int b = 0; b < p.G; ++b) {
    // the cursor's stages, in ring order
    std::vector<std::pair<int, int>> cursor;  // (turn, stage)
    for (Cursor c(p, b); !c.done; c.next()) {
      ++stats[TOTAL];
      cursor.emplace_back(c.turn, c.s);
    }
    size_t k = 0;
    for (int turn = 0; turn < p.turns(b); ++turn) {
      const Work w = p.work(b, turn);
      if (w.q < 0 || w.q >= Q || w.i < 0 || w.i >= C || w.j < 0 ||
          w.j > w.i || w.s0 < 0 || w.s1 > p.S || w.s0 >= w.s1) {
        ++stats[TILE_FAULTS];
        continue;
      }
      const size_t tile = ((size_t)w.q * C + w.i) * C + w.j;
      for (int s = w.s0; s < w.s1; ++s, ++k) {
        // the consumers' turn order is the cursor's
        if (k >= cursor.size() || cursor[k].first != turn ||
            cursor[k].second != s) {
          ++stats[ORDER_FAULTS];
        }
        taken[tile].push_back(s);
      }
      if (w.role != WHOLE) {
        const int r = b / p.P, part = b % p.P;
        const bool adds = w.role == ADDS_PARTIAL;
        const bool bad = turn != p.F || w.parts != p.P ||
                         w.s0 != part * p.S / p.P ||
                         w.s1 != (part + 1) * p.S / p.P ||
                         adds != (part == p.P - 1) ||
                         w.slot != r * (p.P - 1) + (adds ? 0 : part) ||
                         w.slot < 0 || w.slot + (adds ? p.P - 2 : 0) >=
                                           p.slots();
        stats[SPLIT_FAULTS] += bad;
        if (!bad && !adds) ++slot_writes[w.slot];
        if (adds || bad) {
          // the adder reads slots slot .. slot + P - 2: each its tile's
          // part, in increasing part order, so in increasing n
          for (int kk = 0; kk + 1 < w.parts && !bad; ++kk) {
            const int writer = r * p.P + kk;
            const Work ww = p.work(writer, p.F);
            stats[SPLIT_FAULTS] += ww.slot != w.slot + kk ||
                                   ww.q != w.q || ww.i != w.i ||
                                   ww.j != w.j || ww.s1 > w.s0 ||
                                   (kk > 0 && ww.s0 < kk * p.S / p.P);
          }
        }
      }
      if (w.role == WRITES_PARTIAL) continue;
      // the epilogue: the tile's values and the diagonal's zeros, and the
      // mirror's zeros
      for (int tid = 0; tid < CONSUMERS; ++tid) {
        for (int e = 0; e < 64; ++e) {
          const int r = three ? acc_row(tid, e) : f32_row(tid, e / 8);
          const int c = three ? acc_col(tid, e) : f32_col(tid, e % 8);
          const int m1 = w.i * BT + r, m2 = w.j * BT + c;
          store(w.q, m1, m2, w.i != w.j || keep(m1, m2));
          if (w.i > w.j) store(w.q, w.j * BT + r, w.i * BT + c, false);
        }
      }
    }
    if (k != cursor.size()) ++stats[ORDER_FAULTS];
  }
  for (int s : slot_writes) stats[SPLIT_FAULTS] += p.slots() > 0 && s != 1;
  for (int q = 0; q < Q; ++q) {
    for (int l = 0; l < T; ++l) {
      int i, j;
      lower_tile(l, i, j);
      std::vector<int>& s = taken[((size_t)q * C + i) * C + j];
      std::sort(s.begin(), s.end());
      bool whole = (int)s.size() == p.S;
      for (int x = 0; whole && x < p.S; ++x) whole = s[x] == x;
      stats[TILE_FAULTS] += !whole;
    }
  }
  for (size_t o = 0; o < writes.size(); ++o) {
    const int m1 = (int)((o / M) % M), m2 = (int)(o % M);
    stats[WRITE_FAULTS] += writes[o] != 1 || value[o] != (m1 >= m2);
  }
  return stats[TILE_FAULTS] + stats[ORDER_FAULTS] + stats[SPLIT_FAULTS] +
         stats[MAP_FAULTS] + stats[WRITE_FAULTS];
}

extern "C" int tril_out_plan_stats() { return N_STATS; }
