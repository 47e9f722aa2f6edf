// The host build of kernel 8's schedule and index arithmetic
// (tril_out_plan.cuh), for the CPU tests: walks every block, turn and
// stage of one launch of tril_out_tma_kernel or tril_out3_tma_kernel
// (tril_out_kernel.cu) with the cursor their loads (and the three-pass
// splitters) walk and the turns their consumers walk, replays their
// epilogues' and the split tiles' fix-ups' stores, and checks what the
// kernel computes without running it.  tests/test_torch_tril_out_plan.py loads it with ctypes after
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
                  // of the last turn with the tile's stages in part
                  // order, a part whose slot is not its tile's base +
                  // part, a slot written twice, not at all or out of
                  // range, a grid larger than the resident blocks
  MAP_FAULTS,     // the thread, partial and splitter maps not one to one
  WRITE_FAULTS,   // outputs not written exactly once, or a value where
                  // m1 < m2, or a zero where m1 >= m2
  BLOCKS,         // persistent blocks of the launch
  WHOLE_TURNS,    // F
  LAST_TILES,     // tiles of the last turn
  PARTS,          // parts each of those
  BUSIEST,        // the busiest block's stages
  TOTAL,          // all blocks' stages
  FIXUP_FAULTS,   // a split tile's float4s not reduced by exactly one of
                  // its parts, or an element's partials not read from the
                  // tile's P slots in part order
  MOST_READS,     // the most partial float4s one block reads
  SLOTS,          // the split partials of the launch
  N_STATS
};

// The maps of one tile, the same in every launch.
static long long map_faults(int three) {
  long long faults = 0;
  std::vector<int> out(BT * BT, 0), part(BT * BT, 0);
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
    // the partial's floats in slot 3: the tile's row-major layout
    for (int e = 0; e < 64; ++e) {
      const int r = three ? acc_row(tid, e) : f32_row(tid, e / 8);
      const int c = three ? acc_col(tid, e) : f32_col(tid, e % 8);
      const long long p = slot_at(3) + r * BT + c - slot_at(3);
      if (p < 0 || p >= (long long)BT * BT) {
        ++faults;
        continue;
      }
      ++part[p];
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
    // the consumers' A fragments: every float of a stage's A boxes read
    // once over the steps, a warp's loads of one element in 32 banks
    std::vector<int> a(BK_3PASS * BT, 0);
    for (int kk = 0; kk < BK_3PASS / 16; ++kk) {
      for (int tid = 0; tid < CONSUMERS; ++tid) {
        for (int e = 0; e < 8; ++e) {
          const int off = afrag_offset(tid, kk, e);
          const int m1 = afrag_m1(tid, e), n = afrag_n(tid, kk, e);
          const int box = m1 / 32, c = m1 % 32;
          faults += off != box * BK_3PASS * 128 + n * 128 +
                               (((c / 4) ^ (n % 8)) * 16) + (c % 4) * 4;
          faults += off != afrag_offset(tid, 0, e & 3) + afrag_step(kk, e);
          if (off < 0 || off >= BK_3PASS * BT * 4 || off % 4) {
            ++faults;
            continue;
          }
          ++a[off / 4];
        }
      }
      for (int warp = 0; warp < CONSUMERS / 32; ++warp) {
        for (int e = 0; e < 8; ++e) {
          unsigned banks = 0;
          for (int lane = 0; lane < 32; ++lane)
            banks |= 1u << ((afrag_offset(32 * warp + lane, kk, e) / 4) % 32);
          faults += banks != 0xFFFFFFFFu;
        }
      }
    }
    for (int s : a) faults += s != 1;
  }
  return faults;
}

// Walks one launch over (Q, N, M) for `sms` resident blocks of the FFMA
// design (three = 0) or the three-pass one; fills stats[N_STATS] and
// returns the number of faults.
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
  stats[SLOTS] = p.slots();
  stats[MAP_FAULTS] = map_faults(three);
  if (p.G > sms || p.G < 1 || p.slots() > MAX_SLOTS) ++stats[SPLIT_FAULTS];
  const int C = p.C, T = p.per_latent();
  // per tile: the stages taken; per slot: its writer's (q, i, j, s0, s1)
  // and writes; per split tile's float4: its reducers; per output: writes
  // and whether a value was stored
  std::vector<std::vector<int>> taken((size_t)Q * C * C);
  const size_t nslots = p.slots() > 0 ? p.slots() : 1;
  std::vector<int> slot_writes(nslots, 0);
  std::vector<Work> slot_writer(nslots);
  std::vector<std::vector<int>> reducers(nslots);  // by the tile's base
  std::vector<unsigned char> writes((size_t)Q * M * M, 0);
  std::vector<unsigned char> value((size_t)Q * M * M, 0);
  auto store = [&](int q, int m1, int m2, bool is_value) {
    if (m1 >= M || m2 >= M) return;
    const size_t o = ((size_t)q * M + m1) * M + m2;
    ++writes[o];
    value[o] = is_value;
  };
  std::vector<Work> parts_seen;
  for (int b = 0; b < p.G; ++b) {
    // the cursor's stages, in ring order
    std::vector<std::pair<int, int>> cursor;  // (turn, stage)
    for (Cursor c(p, b); !c.done; c.next()) {
      ++stats[TOTAL];
      cursor.emplace_back(c.turn, c.s);
    }
    size_t k = 0;
    long long reads = 0;
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
      if (w.role == PART) {
        const int r = b / p.P, part = b % p.P;
        const bool bad = turn != p.F || w.parts != p.P || w.part != part ||
                         w.base != r * p.P ||
                         w.s0 != part * p.S / p.P ||
                         w.s1 != (part + 1) * p.S / p.P || w.slot() < 0 ||
                         w.slot() >= p.slots() || w.v0() >= w.v1();
        stats[SPLIT_FAULTS] += bad;
        if (bad) continue;
        ++slot_writes[w.slot()];
        slot_writer[w.slot()] = w;
        parts_seen.push_back(w);
        reads += (long long)w.parts * (w.v1() - w.v0());
        // the fix-up: its float4s of the tile, and of the mirror's zeros
        for (int v = w.v0(); v < w.v1(); ++v) {
          reducers[w.base].push_back(v);
          const int row = v / (BT / 4), c = 4 * (v % (BT / 4));
          for (int e = 0; e < 4; ++e) {
            const int m1 = w.i * BT + row, m2 = w.j * BT + c + e;
            store(w.q, m1, m2, w.i != w.j || keep(m1, m2));
            if (w.i > w.j) store(w.q, w.j * BT + row, w.i * BT + c + e,
                                 false);
          }
        }
        continue;
      }
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
    stats[MOST_READS] = std::max(stats[MOST_READS], reads);
  }
  for (int s : slot_writes) stats[SPLIT_FAULTS] += p.slots() > 0 && s != 1;
  // the kernel entry's report of the reads is the walk's
  stats[FIXUP_FAULTS] += most_fixup_reads(p) != stats[MOST_READS];
  // each element of a split tile: the P slots it adds, in the kernel's
  // order base + 0, ..., base + P - 1, are the tile's parts in increasing
  // n; and one part reduces it
  for (const Work& w : parts_seen) {
    for (int kk = 0; kk < w.parts; ++kk) {
      const Work& ww = slot_writer[w.base + kk];
      stats[FIXUP_FAULTS] +=
          slot_writes[w.base + kk] != 1 || ww.q != w.q || ww.i != w.i ||
          ww.j != w.j || ww.part != kk ||
          (kk > 0 && ww.s0 != slot_writer[w.base + kk - 1].s1);
    }
    if (w.part == 0) {
      std::vector<int> v = reducers[w.base];
      std::sort(v.begin(), v.end());
      bool once = (int)v.size() == TILE_VEC;
      for (int x = 0; once && x < TILE_VEC; ++x) once = v[x] == x;
      stats[FIXUP_FAULTS] += !once;
    }
  }
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
         stats[MAP_FAULTS] + stats[WRITE_FAULTS] + stats[FIXUP_FAULTS];
}

extern "C" int tril_out_plan_stats() { return N_STATS; }
