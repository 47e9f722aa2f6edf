// Kernel 7: the masked adam update of every parameter leaf in one launch, on
// Hopper (sm_90a), float32 and float64.
//
// For each leaf (p, g, mu, nu) of the table, with c = count + 1,
// bc1 = 1 - b1^c and bc2 = 1 - b2^c:
//   free leaf:   mu' = (1 - b1) g + b1 mu,  nu' = (1 - b2) g^2 + b2 nu,
//                p' = p - lr (mu' / bc1) / (sqrt(nu' / bc2) + eps);
//   frozen leaf: mu' = b1 mu, nu' = b2 nu, p unchanged (not written);
// and count' = count + 1.  count is read on the device, and lr too where it
// is a device scalar (the schedules), so nothing reads a device value on
// the host and the launch sits inside a captured CUDA graph.
//
// Replaces no Pallas kernel: it is the JAX package's optax.adam
// (hetmogp_tpu/train.py::make_optimizer, :346-366) under the step's mask,
// which XLA fuses into the step on the TPU.  The plain version,
// hetmogp_tpu_torch/train.py::_adam, is about ten elementwise kernels a free
// leaf and two a frozen one.
//
// The arithmetic is _adam's, operation for operation and in its order, with
// each product, sum, quotient and square root rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn and their double forms), so
// that nvcc contracts nothing into a fused multiply-add and the result is
// _adam's on the card to the bit; the bias corrections are powf / pow, as
// torch.pow computes them.
//
// What bounds it on an H100: bytes.  A free leaf reads p, g, mu, nu and
// writes p, mu, nu (28 bytes an element in float32), a frozen one reads and
// writes mu, nu (16); the flagship's 4.2 million parameters, nearly all of
// them q_sqrt, are ~0.04 ms at 3.35 TB/s when q is free.  Each block takes
// ELEMS consecutive elements of one leaf (the leaves' first blocks are in
// the table), so the whole update is one grid.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 32;
constexpr int THREADS = 256;
constexpr int ITEMS = 4;  // elements a thread
constexpr long long ELEMS = (long long)THREADS * ITEMS;

struct Leaf {
  const void* p;
  const void* g;  // null: a frozen leaf
  const void* mu;
  const void* nu;
  void* p_out;
  void* mu_out;
  void* nu_out;
  long long n;
  long long first_block;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_(double a, double b) { return pow(a, b); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Table table,
                const long long* __restrict__ count,
                long long* __restrict__ count_out,
                const T* __restrict__ lr_ptr, double lr_value) {
  // train.py's constants as torch rounds them: b1, b2 and eps, and the
  // Python floats 1 - b1 and 1 - b2, each cast to T
  const T b1 = T(0.9), b2 = T(0.999), eps = T(1e-8);
  const T one_b1 = T(1.0 - 0.9), one_b2 = T(1.0 - 0.999);
  int l = 0;
  while (l + 1 < table.count &&
         (long long)blockIdx.x >= table.leaf[l + 1].first_block) {
    ++l;
  }
  const Leaf& leaf = table.leaf[l];
  const long long c = *count + 1;
  if (count_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    *count_out = c;
  }
  const T ct = T(c);
  const T bc1 = sub_rn(T(1), pow_(b1, ct));
  const T bc2 = sub_rn(T(1), pow_(b2, ct));
  const T lr = lr_ptr != nullptr ? *lr_ptr : T(lr_value);
  const T* g = static_cast<const T*>(leaf.g);
  const T* mu = static_cast<const T*>(leaf.mu);
  const T* nu = static_cast<const T*>(leaf.nu);
  T* mu_out = static_cast<T*>(leaf.mu_out);
  T* nu_out = static_cast<T*>(leaf.nu_out);
  const long long base = ((long long)blockIdx.x - leaf.first_block) * ELEMS;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (long long)k * THREADS + threadIdx.x;
    if (i >= leaf.n) break;
    if (g == nullptr) {
      mu_out[i] = mul_rn(b1, mu[i]);
      nu_out[i] = mul_rn(b2, nu[i]);
      continue;
    }
    const T gi = g[i];
    const T m1 = add_rn(mul_rn(one_b1, gi), mul_rn(b1, mu[i]));
    const T n1 = add_rn(mul_rn(one_b2, mul_rn(gi, gi)), mul_rn(b2, nu[i]));
    mu_out[i] = m1;
    nu_out[i] = n1;
    const T step = div_rn(mul_rn(lr, div_rn(m1, bc1)),
                          add_rn(sqrt_rn(div_rn(n1, bc2)), eps));
    static_cast<T*>(leaf.p_out)[i] =
        sub_rn(static_cast<const T*>(leaf.p)[i], step);
  }
}

// The leaves' first blocks, from their sizes; the number of blocks.
long long plan(Table& table) {
  long long blocks = 0;
  for (int l = 0; l < table.count; ++l) {
    table.leaf[l].first_block = blocks;
    blocks += (table.leaf[l].n + ELEMS - 1) / ELEMS;
  }
  return blocks;
}

template <typename T>
int launch(const void* const* ptrs, const long long* sizes, int leaves,
           const long long* count, long long* count_out, const T* lr_ptr,
           double lr_value, cudaStream_t stream) {
  if (leaves <= 0 || leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Table table;
  table.count = leaves;
  for (int l = 0; l < leaves; ++l) {
    const void* const* q = ptrs + 7 * l;
    if (sizes[l] <= 0 || q[0] == nullptr || q[2] == nullptr ||
        q[3] == nullptr || q[5] == nullptr || q[6] == nullptr ||
        (q[1] != nullptr && q[4] == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
    table.leaf[l] = Leaf{q[0], q[1], q[2], q[3], const_cast<void*>(q[4]),
                         const_cast<void*>(q[5]), const_cast<void*>(q[6]),
                         sizes[l], 0};
  }
  const long long blocks = plan(table);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  adam_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      table, count, count_out, lr_ptr, lr_value);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: 7 pointers a leaf (p, g or null for a frozen leaf, mu, nu, p_out or
// null for a frozen leaf, mu_out, nu_out); sizes: the leaves' element
// counts (each > 0); lr_ptr: a device scalar of the leaves' dtype, or null
// for lr_value; count_out may be null (a later launch of the same step
// writes it).
extern "C" int hetmogp_adam_f32(const void* const* ptrs, const long long* sizes,
                                int leaves, const long long* count,
                                long long* count_out, const float* lr_ptr,
                                double lr_value, cudaStream_t stream) {
  return launch<float>(ptrs, sizes, leaves, count, count_out, lr_ptr,
                       lr_value, stream);
}

extern "C" int hetmogp_adam_f64(const void* const* ptrs, const long long* sizes,
                                int leaves, const long long* count,
                                long long* count_out, const double* lr_ptr,
                                double lr_value, cudaStream_t stream) {
  return launch<double>(ptrs, sizes, leaves, count, count_out, lr_ptr,
                        lr_value, stream);
}

// How many leaves one launch takes (the wrapper splits a longer table).
extern "C" int hetmogp_adam_max_leaves() { return MAX_LEAVES; }
