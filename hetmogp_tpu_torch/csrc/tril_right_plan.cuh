// Kernel 4's index arithmetic (tril_right_kernel.cu, the TMA-fed design):
// which output each FMA thread holds, which stages of a tile's reduction
// each warp skips, masks or runs in full, and where each row-sum partial
// goes.  Plain C++ behind K4_HD, which is __host__ __device__ under nvcc
// and empty under a host compiler, so that the CPU tests walk every block,
// turn, tile, thread and stage of a launch with the functions the kernel
// calls (tril_right_plan_host.cpp, tests/test_torch_tril_right_plan.py).
// No CUDA header is included here.
//
// A block's tile is BM rows n by BN columns k of out; its reduction runs
// over m from k0 to M in stages of BK, the first BN / BK of which straddle
// the diagonal.  The FMA warps split the tile into a WARPS_M x WARPS_N
// grid of WR x WC warp tiles, and a warp's lanes into LR x LC, each lane an
// 8 x TN register tile: rows lr + LR i, columns 4 lc + c + WC / GROUPS h
// (i < 8, c < 4, h < GROUPS = TN / 4) of its warp tile.  Since a warp holds WC columns
// and no more, it skips outright the stages whose every m lies below its
// first column, masks (m < k) only the WC / BK stages that straddle its
// columns, and runs the rest unmasked.

#pragma once

#if defined(__CUDACC__)
#define K4_HD __host__ __device__ __forceinline__
#else
#define K4_HD inline
#endif

namespace tril_right_plan {

constexpr int BM = 128;                // rows n of a tile
constexpr int BN = 128;                // columns k of a tile
constexpr int BK = 32;                 // reduction depth m of a stage
constexpr int TN = 8;                  // columns of a lane's 8-row tile
constexpr int GROUPS = TN / 4;         // its float4s along a row
constexpr int WARPS = BM * BN / (8 * TN * 32);  // FMA warps of a block
constexpr int WC = 32;                 // columns of a warp tile
constexpr int WR = BM * BN / (WARPS * WC);  // rows of a warp tile
constexpr int WARPS_N = BN / WC;
constexpr int WARPS_M = BM / WR;
constexpr int LC = WC / TN;            // lanes along a warp tile's row
constexpr int LR = 32 / LC;            // lanes along its column
constexpr int PARTS = WARPS_N;         // row-sum partials of a tile's row
static_assert(WARPS_M * WARPS_N == WARPS, "the warp tiles make a tile");
static_assert(LR * 8 == WR, "8 rows a lane make a warp tile's rows");
static_assert(WC % BK == 0, "a warp's columns span whole stages");

// The warp's column of the grid of warp tiles.  Warp w issues on the SM's
// sub-partition w % 4, and warps with more columns to the right skip more
// of a tile's stages, so every second four warps take the columns in
// reverse: the warps that share a sub-partition then skip as many stages
// together as those of any other, and no sub-partition is left with the
// tile's longest reductions alone.
K4_HD int warp_n(int warp) {
  const int wn = warp % WARPS_N;
  return (warp / 4) & 1 ? WARPS_N - 1 - wn : wn;
}

// Row of the tile that acc[i][.] of (warp, lane) holds.
K4_HD int row(int warp, int lane, int i) {
  return (warp / WARPS_N) * WR + lane / LC + LR * i;
}

// Column of the tile that acc[.][j] of (warp, lane) holds: GROUPS
// float4s, WC / GROUPS apart.
K4_HD int col(int warp, int lane, int j) {
  return warp_n(warp) * WC + 4 * (lane % LC) + (j & 3) +
         (WC / GROUPS) * (j >> 2);
}

// Stages [0, first_stage) of a tile hold only m below every column of the
// warp: skipped.  Stages [first_stage, full_stage) straddle its columns:
// masked.  From full_stage on every m is at or past every column.
K4_HD int first_stage(int warp) { return warp_n(warp) * WC / BK; }
K4_HD int full_stage(int warp) { return (warp_n(warp) + 1) * WC / BK; }

// tril(L)[m, k] is read (the mask of the straddling stages); m and k
// relative to the tile's k0.
K4_HD bool keep(int m, int k) { return m >= k; }

// stages of the tile whose columns start at k0
K4_HD int stages(int M, int k0) { return (M - k0 + BK - 1) / BK; }

// The tile's k0 for the schedule's column tile ct: the mirror, so the
// heaviest reductions come first (tril_tma.cuh).
K4_HD int k0_of(int C, int ct) { return (C - 1 - ct) * BN; }

// The row sums' partials: PARTS a tile's row, one per warp column (each
// the shuffle tree of the LC lanes that share the row, then written by the
// lane with lc == 0); a row's C * PARTS partials are added in increasing
// column order, a tile's PARTS in order, then the tiles' sums in order
// (tril_right_kernel.cu: row_sum_kernel).
K4_HD bool writes_partial(int lane) { return lane % LC == 0; }
K4_HD int partial(int k0, int warp) { return (k0 / BN) * PARTS + warp_n(warp); }

}  // namespace tril_right_plan
