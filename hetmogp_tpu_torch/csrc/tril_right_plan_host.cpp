// The host build of kernel 4's schedule and index arithmetic
// (tril_tiles.cuh, tril_right_plan.cuh), for the CPU tests: walks every
// block, turn, tile, FMA thread and stage of one launch of
// tril_right_tma_kernel (tril_right_kernel.cu) with the loops the kernel
// runs and the functions it calls, and checks what the kernel computes
// without running it.  tests/test_torch_tril_right_plan.py loads it with
// ctypes after compiling it with a host C++ compiler:
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libplan.so tril_right_plan_host.cpp
//
// The CUDA build (ops/_build.py) compiles the *.cu sources only.

#include <stdint.h>

#include <algorithm>
#include <vector>

#include "tril_right_plan.cuh"
#include "tril_tiles.cuh"

using namespace tril_right_plan;

// What the walk counts (`stats`, in this order).
enum Stat {
  OUTPUTS,        // outputs (q, n, k < M) written
  TWICE,          // outputs written more than once
  NEVER,          // outputs never written
  CHAIN_FAULTS,   // chains that skip, repeat, reorder or end short of M,
                  // or that read an entry m < k, or mask or skip one m >= k
  FMAS,           // chain entries (m >= k, m < M) multiplied
  MASKED,         // entries m < k zeroed in a straddling stage
  SKIPPED,        // entries m < k of stages a warp skips
  PART_FAULTS,    // row-sum partials written other than once, or not the
                  // sum of the warp's WC columns of their row
  BLOCKS,         // persistent blocks of the launch
  TILES,          // tiles walked
  N_STATS
};

// Walks one launch over (Q, N, M) on `sms` SMs; fills stats[N_STATS] and
// returns the number of faults (0: every output once, every chain whole).
extern "C" long long tril_right_plan_walk(int Q, int N, int M, int sms,
                                          long long* stats) {
  std::fill(stats, stats + N_STATS, 0LL);
  const int R = (N + BM - 1) / BM, C = (M + BN - 1) / BN;
  const tril_tma::Tiles tiles = tril_tma::make_tiles_on(Q, R, C, sms);
  const int G = tril_tma::persistent_blocks_on(tiles, sms);
  const int units = tiles.units();
  const int parts = C * PARTS;
  std::vector<uint8_t> written((size_t)Q * N * M, 0);
  std::vector<uint8_t> part_written((size_t)Q * N * parts, 0);
  stats[BLOCKS] = G;

  for (int b = 0; b < G; ++b) {
    for (int turn = 0;; ++turn) {
      const int u = tiles.index(turn, b, G);
      if (u >= units) break;
      for (int p = 0; p < tiles.tiles_in(u); ++p) {
        int q, rt, ct;
        tiles.decode(u, p, q, rt, ct);
        const int n0 = rt * BM;
        const int k0 = k0_of(C, ct);
        const int S = stages(M, k0);
        ++stats[TILES];
        for (int warp = 0; warp < WARPS; ++warp) {
          const int s_first = first_stage(warp), s_full = full_stage(warp);
          for (int lane = 0; lane < 32; ++lane) {
            // each column's chain, as the stage loop and consume<MASK> run it
            for (int j = 0; j < TN; ++j) {
              const int k = k0 + col(warp, lane, j);
              int next = k;  // the next m the chain must take
              bool fault = false;
              // m past M, and columns k past M, are TMA's zero fill
              for (int s = 0; s < S && k < M; ++s) {
                const int m0 = k0 + s * BK, m1 = std::min(m0 + BK, M);
                if (s < s_first) {  // skipped: every m below k
                  fault |= m1 - 1 >= k;
                  stats[SKIPPED] += m1 - m0;
                } else if (s >= s_full) {  // multiplied, unmasked
                  fault |= m0 < k || m0 != next;
                  next = m1;
                  stats[FMAS] += m1 - m0;
                } else {  // straddling: masked entry by entry
                  for (int m = m0; m < m1; ++m) {
                    if (!keep(m - k0, k - k0)) {
                      fault |= m >= k;
                      ++stats[MASKED];
                    } else {
                      fault |= m < k || m != next;
                      next = m + 1;
                      ++stats[FMAS];
                    }
                  }
                }
              }
              fault |= k < M && next != M;
              stats[CHAIN_FAULTS] += fault;
            }
            // the epilogue's stores and row-sum partials
            for (int i = 0; i < 8; ++i) {
              const int n = n0 + row(warp, lane, i);
              if (n >= N) continue;
              for (int j = 0; j < TN; ++j) {
                const int k = k0 + col(warp, lane, j);
                if (k < M) {
                  uint8_t& w = written[((size_t)q * N + n) * M + k];
                  w = (uint8_t)std::min(w + 1, 2);
                }
              }
              if (!writes_partial(lane)) continue;
              // the shuffle tree adds lanes lane ^ x, x < LC: they must
              // hold this row and, together, the warp's WC columns once
              std::vector<int> cols;
              bool fault = false;
              for (int x = 0; x < LC; ++x) {
                fault |= row(warp, lane ^ x, i) != row(warp, lane, i);
                for (int j = 0; j < TN; ++j) {
                  cols.push_back(col(warp, lane ^ x, j));
                }
              }
              std::sort(cols.begin(), cols.end());
              for (int c = 0; c < (int)cols.size(); ++c) {
                fault |= cols[c] != warp_n(warp) * WC + c;
              }
              fault |= (int)cols.size() != WC;
              const int slot = partial(k0, warp);
              fault |= slot < 0 || slot >= parts;
              if (!fault) {
                uint8_t& w = part_written[((size_t)q * N + n) * parts + slot];
                w = (uint8_t)std::min(w + 1, 2);
              }
              stats[PART_FAULTS] += fault;
            }
          }
        }
      }
    }
  }
  for (uint8_t w : written) {
    stats[OUTPUTS] += w > 0;
    stats[TWICE] += w > 1;
    stats[NEVER] += w == 0;
  }
  for (uint8_t w : part_written) stats[PART_FAULTS] += w != 1;
  return stats[TWICE] + stats[NEVER] + stats[CHAIN_FAULTS] +
         stats[PART_FAULTS];
}

extern "C" int tril_right_plan_stats() { return N_STATS; }
