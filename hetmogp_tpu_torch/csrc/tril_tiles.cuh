// The static tile schedule of the TMA-fed triangular products (kernels A,
// 3 and 4; tril_tma.cuh describes it), in plain C++ behind TILES_HD,
// which is __host__ __device__ under nvcc and empty under a host compiler,
// so that the CPU tests walk the same schedule the kernels run
// (tril_right_plan_host.cpp).  No CUDA header is included here.

#pragma once

#if defined(__CUDACC__)
#define TILES_HD __host__ __device__ __forceinline__
#else
#define TILES_HD inline
#endif

namespace tril_tma {

// The output tiles of one launch, grouped into work units.  Unpaired, a
// unit is one tile, heaviest column tile first.  Paired, a unit is the two
// column tiles C - 1 - p and p of one row tile (one tile where they
// coincide), so every unit has the same C + 1 blocks of reduction, and
// consecutive units are the pairs of one row tile, so the blocks of one
// turn read their A rows from L2 rather than once per column tile from
// device memory.
struct Tiles {
  int Q, R, C;  // latents, row tiles, column tiles
  int paired;
  TILES_HD int pairs() const { return (C + 1) / 2; }
  TILES_HD int units() const { return Q * R * (paired ? pairs() : C); }
  // unit index of block b (of G) on its turn-th turn: a snake over blocks
  TILES_HD int index(int turn, int b, int G) const {
    return turn * G + ((turn & 1) ? G - 1 - b : b);
  }
  TILES_HD int tiles_in(int u) const {
    return paired && 2 * (u % pairs()) != C - 1 ? 2 : 1;
  }
  // the i-th tile (q, row tile, column tile) of unit u
  TILES_HD void decode(int u, int i, int& q, int& rt, int& ct) const {
    int rest;
    if (paired) {
      const int p = u % pairs();
      ct = i == 0 ? C - 1 - p : p;
      rest = u / pairs();
    } else {
      ct = C - 1 - u / (Q * R);
      rest = u % (Q * R);
    }
    q = rest / R;
    rt = rest % R;
  }
};

// The schedule of Q latents of R x C tiles on `sms` SMs: paired where
// there are at least two units for every SM (a turn that is not full then
// costs little), else single tiles, heaviest first, which balance a short
// launch better.
inline Tiles make_tiles_on(int Q, int R, int C, int sms) {
  const long long pair_units = (long long)Q * R * ((C + 1) / 2);
  return Tiles{Q, R, C, pair_units >= 2LL * sms ? 1 : 0};
}

// Persistent grid size: one block per SM, at most one per work unit.
inline int persistent_blocks_on(const Tiles& t, int sms) {
  const long long units =
      (long long)t.Q * t.R * (t.paired ? (t.C + 1) / 2 : t.C);
  return (int)(units < sms ? units : sms);
}

}  // namespace tril_tma
