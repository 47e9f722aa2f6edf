// The host build of kernel 5's schedule and index arithmetic
// (tril_right3_plan.cuh), for the CPU tests: walks every block, turn, unit
// and stage of one launch of tril_right3_tma_kernel (tril_right3_kernel.cu)
// with the cursor the kernel's loads, splitter and consumers walk, and the
// maps its splitter and epilogue use, and checks what the kernel computes
// without running it.  tests/test_torch_tril_right3_plan.py loads it with
// ctypes after compiling it with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libplan.so tril_right3_plan_host.cpp
//
// The CUDA build (ops/_build.py) compiles the *.cu sources only.

#include <stdint.h>

#include <algorithm>
#include <vector>

#include "tril_right3_plan.cuh"

using namespace tril_right3_plan;

// What the walk counts (`stats`, in this order).
enum Stat {
  TILE_FAULTS,   // tiles whose reduction is not [0, S) exactly once, as
                 // one whole unit or as a head and a tail
  CHAIN_FAULTS,  // columns k < M of a tile whose entries m >= k, m < M are
                 // not each taken once in increasing order within a part,
                 // or whose entries m < k are not each masked
  SPLIT_FAULTS,  // split tiles without exactly one writer and one adder,
                 // an adder before its writer, or a slot out of range
  MAP_FAULTS,    // the splitter's, the epilogue's or the partial's maps
                 // not one to one
  MACS,          // entries m >= k, m < M multiplied, over the columns
  MASKED,        // entries m < k zeroed in a straddling stage
  BLOCKS,        // persistent blocks of the launch
  UNITS,         // units walked (a split tile's parts count two)
  SPLIT,         // the split: column tile 0's head stages (0: none)
  BUSIEST,       // the busiest block's stages
  TOTAL,         // all blocks' stages
  WAIT_TURNS,    // adders on the same turn as their writer
  N_STATS
};

// The maps of one stage and one tile, the same in every launch.
static long long map_faults() {
  long long faults = 0;
  std::vector<int> seen(BK * 32, 0), bytes(BK * 128 * 2 / 8, 0);
  for (int t = 0; t < SPLITTERS; ++t) {
    for (int i = 0; i < SPLIT_VEC; ++i) {
      const int m = split_row(t, i), c4 = split_c4(t, i);
      if (m < 0 || m >= BK || c4 < 0 || c4 >= 32) {
        ++faults;
        continue;
      }
      ++seen[m * 32 + c4];
      // the hi tile's 8-byte piece: two 64-column boxes of 64 rows of 128
      // bytes, chunk c of row m at c ^ (m % 8)
      const int off = split_offset(m, c4);
      const int box = (4 * c4) / 64, col = (4 * c4) % 64;
      const int want = box * BK * 128 + m * 128 +
                       (((col / 8) ^ (m % 8)) * 16) + (col % 8) * 2;
      faults += off != want || off % 8 != 0;
      if (off >= 0 && off < BK * 128 * 2) ++bytes[off / 8];
    }
  }
  for (int s : seen) faults += s != 1;
  for (int s : bytes) faults += s != 1;
  std::vector<int> out(BM * BN, 0), part(32 * CONSUMERS, 0);
  for (int tid = 0; tid < CONSUMERS; ++tid) {
    for (int e = 0; e < 64; ++e) {
      const int r = acc_row(tid, e), c = acc_col(tid, e);
      if (r < 0 || r >= BM || c < 0 || c >= BN) {
        ++faults;
        continue;
      }
      ++out[r * BN + c];
      // the epilogue stores accumulators 2 x, 2 x + 1 as one float2
      if (e % 2 == 1) faults += c != acc_col(tid, e - 1) + 1 ||
                                r != acc_row(tid, e - 1);
    }
    for (int x = 0; x < 32; ++x) {
      const long long p = partial_at(3, x, tid) - partial_at(3, 0, 0);
      if (p < 0 || p >= 32 * CONSUMERS) {
        ++faults;
        continue;
      }
      ++part[p];
    }
  }
  for (int s : out) faults += s != 1;
  for (int s : part) faults += s != 1;
  return faults;
}

// Walks one launch over (Q, N, M) on `sms` SMs; fills stats[N_STATS] and
// returns the number of faults.
extern "C" long long tril_right3_plan_walk(int Q, int N, int M, int sms,
                                           long long* stats) {
  std::fill(stats, stats + N_STATS, 0LL);
  const Plan p = make_plan(Q, N, M, sms);
  const int G = blocks(p, sms);
  stats[BLOCKS] = G;
  stats[SPLIT] = p.split;
  stats[BUSIEST] = busiest(p, sms);
  stats[MAP_FAULTS] = map_faults();
  // per tile, the stages taken; per slot, the writer's and adder's units
  const long long tiles = (long long)Q * p.R * p.C;
  std::vector<std::vector<int>> taken(tiles);
  std::vector<int> writer(Q * p.R, -1), adder(Q * p.R, -1);
  std::vector<int> writes(Q * p.R, 0), adds(Q * p.R, 0);
  for (int b = 0; b < G; ++b) {
    int unit = -1, part = -1;
    for (Cursor c(p, b, G); !c.done; c.next()) {
      ++stats[TOTAL];
      const Work& w = c.w;
      if (c.u != unit || c.i != part) {  // a unit's first stage
        unit = c.u;
        part = c.i;
        ++stats[UNITS];
        stats[TILE_FAULTS] += !c.first();
        if (w.role != WHOLE) {
          const bool bad = w.j != 0 || w.slot < 0 || w.slot >= Q * p.R ||
                           w.slot >= MAX_SPLIT ||
                           w.slot != w.q * p.R + w.rt;
          stats[SPLIT_FAULTS] += bad;
          if (!bad) {
            (w.role == WRITES_PARTIAL ? writer : adder)[w.slot] = c.u;
            ++(w.role == WRITES_PARTIAL ? writes : adds)[w.slot];
          }
        }
      }
      const long long tile = ((long long)w.q * p.R + w.rt) * p.C + w.j;
      if (w.q < 0 || w.q >= Q || w.rt < 0 || w.rt >= p.R || w.j < 0 ||
          w.j >= p.C || c.s < w.s0 || c.s >= w.s1) {
        ++stats[TILE_FAULTS];
        continue;
      }
      taken[tile].push_back(c.s);
    }
  }
  for (int slot = 0; slot < Q * p.R; ++slot) {
    if (!p.split) {
      stats[SPLIT_FAULTS] += writes[slot] != 0 || adds[slot] != 0;
      continue;
    }
    stats[SPLIT_FAULTS] += writes[slot] != 1 || adds[slot] != 1 ||
                           writer[slot] >= adder[slot];
    stats[WAIT_TURNS] += writer[slot] / G == adder[slot] / G;
  }
  // every tile's stages [0, S) once; then each of its columns' chains, as
  // the splitter masks and the consumers multiply a stage
  for (long long tile = 0; tile < tiles; ++tile) {
    const int j = (int)(tile % p.C);
    const int S = stages(M, j), k0 = j * BN;
    std::vector<int>& s = taken[tile];
    std::sort(s.begin(), s.end());
    bool whole = (int)s.size() == S;
    for (int i = 0; whole && i < S; ++i) whole = s[i] == i;
    stats[TILE_FAULTS] += !whole;
    for (int kk = 0; kk < BN && k0 + kk < M; ++kk) {
      const int k = k0 + kk;
      int next = k;
      bool fault = false;
      for (int st : s) {
        for (int mm = 0; mm < BK; ++mm) {
          const int m = k0 + st * BK + mm;
          if (m >= M) break;  // TMA's zero fill
          const bool kept = !straddles(st) || keep(st * BK + mm, kk);
          if (!kept) {
            fault |= m >= k;
            ++stats[MASKED];
          } else {
            fault |= m < k || m != next;
            next = m + 1;
            ++stats[MACS];
          }
        }
      }
      fault |= next != M;
      stats[CHAIN_FAULTS] += fault;
    }
  }
  return stats[TILE_FAULTS] + stats[CHAIN_FAULTS] + stats[SPLIT_FAULTS] +
         stats[MAP_FAULTS];
}

extern "C" int tril_right3_plan_stats() { return N_STATS; }
