// Probe of the RBF kernel's store path on Hopper (sm_90a): the designs and
// launch parameters that csrc/rbf_kernel.cu was chosen from.  Built and
// driven by probes/rbf_store.py; not part of the package's library.
//
// It includes the package's source, so the vector and scalar kernels timed
// here are the shipped ones; its own launcher opens up the two parameters the
// library fixes (blocks per SM; streaming st.global.cs stores, which the
// library does not instantiate); and it adds the alternative that was
// measured against the float4 stores: the same arithmetic into a
// double-buffered shared-memory tile that one thread hands to the TMA unit
// (cp.async.bulk, shared -> global), so the threads fill tile k + 1 while
// tile k drains.

#include "../csrc/rbf_kernel.cu"

#include <stdint.h>

namespace {

constexpr int BULK_ROWS = 8;  // rows per thread per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// blockDim = (TX, TY) as the vector kernel's; a tile is BULK_ROWS * TY rows
// of 4 TX columns (32 KiB), two tiles in dynamic shared memory.
template <int DX>
__global__ void __launch_bounds__(VEC_THREADS)
rbf_cross_bulk_kernel(const float* __restrict__ X, const float* __restrict__ Z,
                      const float* __restrict__ ls,
                      const float* __restrict__ var, float* __restrict__ out,
                      int N, int M, int ls_cols, int rows_per_block) {
  extern __shared__ __align__(128) float tiles[];
  const int q = blockIdx.z;
  const int TY = blockDim.y;
  const int width = blockDim.x * VEC_COLS;  // tile columns
  const int m0 = blockIdx.y * width;
  const int m = m0 + threadIdx.x * VEC_COLS;
  const bool active = m < M;
  const int cols = min(width, M - m0);
  const int tile_rows = BULK_ROWS * TY;
  const int n_begin = blockIdx.x * rows_per_block;
  const int n_end = min(N, n_begin + rows_per_block);
  const bool leader = threadIdx.x == 0 && threadIdx.y == 0;

  float il[DX], z[DX][VEC_COLS];
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    il[d] = 1.0f / ls[(size_t)q * ls_cols + (ls_cols == 1 ? 0 : d)];
  }
  if (active) {
    const float* Zq = Z + ((size_t)q * M + m) * DX;
#pragma unroll
    for (int c = 0; c < VEC_COLS; ++c) {
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        z[d][c] = __fmul_rn(Zq[c * DX + d], il[d]);
      }
    }
  }
  const float v = var[q];

  int buf = 0;
  for (int t0 = n_begin; t0 < n_end; t0 += tile_rows) {
    // the bulk store that read this buffer two tiles ago has drained
    if (leader) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
    float* tb = tiles + (size_t)buf * tile_rows * width;
    if (active) {
#pragma unroll
      for (int j = 0; j < BULK_ROWS; ++j) {
        const int r = j * TY + threadIdx.y;
        if (t0 + r < n_end) {
          *reinterpret_cast<float4*>(tb + r * width + threadIdx.x * VEC_COLS) =
              rbf_row<DX>(X, t0 + r, il, z, v);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (leader) {
      const int rows = min(tile_rows, n_end - t0);
      float* dst = out + ((size_t)q * N + t0) * M + m0;
      if (cols == M && width == M) {  // whole rows: one contiguous copy
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                "l"(dst), "r"(smem_u32(tb)), "r"(rows * M * 4)
            : "memory");
      } else {
        for (int r = 0; r < rows; ++r) {
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
              ::"l"(dst + (size_t)r * M), "r"(smem_u32(tb + r * width)),
              "r"(cols * 4)
              : "memory");
        }
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    buf ^= 1;
  }
  // shared memory must outlive the copies that read it
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DX>
int launch_bulk(const float* X, const float* Z, const float* ls,
                const float* var, float* out, int Q, int N, int M, int ls_cols,
                int blocks_per_sm, cudaStream_t stream) {
  VecGrid g = vec_grid(Q, N, M, blocks_per_sm);
  // whole tiles per block, so that only a block's last tile is short
  const int tile_rows = BULK_ROWS * g.block.y;
  g.rows_per_block = (g.rows_per_block + tile_rows - 1) / tile_rows * tile_rows;
  g.grid.x = (N + g.rows_per_block - 1) / g.rows_per_block;
  const int smem = 2 * tile_rows * g.block.x * VEC_COLS * sizeof(float);
  cudaFuncSetAttribute(rbf_cross_bulk_kernel<DX>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rbf_cross_bulk_kernel<DX><<<g.grid, g.block, smem, stream>>>(
      X, Z, ls, var, out, N, M, ls_cols, g.rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// The shipped vector kernel (Dx = 2) at a given number of blocks per SM, with
// plain or streaming stores.
extern "C" int probe_rbf_vec(const float* X, const float* Z, const float* ls,
                             const float* var, float* out, int Q, int N, int M,
                             int Dx, int ls_cols, int blocks_per_sm,
                             int stream_stores, cudaStream_t stream) {
  if (Dx != 2 || M % VEC_COLS || reinterpret_cast<size_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const VecGrid g = vec_grid(Q, N, M, blocks_per_sm);
  if (stream_stores) {
    rbf_cross_vec_kernel<2, true><<<g.grid, g.block, 0, stream>>>(
        X, Z, ls, var, out, N, M, ls_cols, g.rows_per_block);
  } else {
    rbf_cross_vec_kernel<2, false><<<g.grid, g.block, 0, stream>>>(
        X, Z, ls, var, out, N, M, ls_cols, g.rows_per_block);
  }
  return (int)cudaGetLastError();
}

// The TMA bulk-store alternative (Dx = 2, M % 4 == 0, out 16-byte aligned).
extern "C" int probe_rbf_bulk(const float* X, const float* Z, const float* ls,
                              const float* var, float* out, int Q, int N,
                              int M, int Dx, int ls_cols, int blocks_per_sm,
                              cudaStream_t stream) {
  if (Dx != 2 || M % VEC_COLS || reinterpret_cast<size_t>(out) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_bulk<2>(X, Z, ls, var, out, Q, N, M, ls_cols, blocks_per_sm,
                        stream);
}
