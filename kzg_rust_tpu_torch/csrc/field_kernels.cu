// Field kernels for Hopper (sm_90a): the Fp and Fr Montgomery products (K1,
// K2) and the small elementwise launchers that share their device functions
// (modular add and sub, compare, and the modular sum along a leading axis).
//
// K1 replaces kzg_rust_tpu/ops/pallas_kernels.py:248 mont_mul_fp_pallas and
// K2 replaces :252 mont_mul_fr_pallas (one factory, _make_mont_mul :202).
// What bounds them here: integer multiply-adds.  A CIOS product issues
// 2 N^2 + N 32x32->64-bit word products (312 for Fp, 136 for Fr) against
// 3 N words of traffic (144 or 96 bytes), far above the card's
// bytes-to-IMAD balance, so the kernels keep each operand in registers of
// one thread (no shared memory, no cross-thread carries) and leave the
// IMAD pipes as the only limit.  The TPU kernel's devices (12-bit limbs,
// int8 Toeplitz REDC on the MXU, roll-and-mask shifts, carry lookahead)
// answer a machine without a 32-bit multiplier and are not carried over.
//
// Operand indexing: element i of the output reads element
// (i / div) % mod of each input, which covers a full operand (div 1,
// mod n), a broadcast scalar (mod 1) and a broadcast row or column of a
// 2-D batch, so callers never materialise a broadcast copy.
//
// C interface: every entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 256;

enum Op { kMul = 0, kAdd = 1, kSub = 2 };

template <class F, int OP>
__global__ void __launch_bounds__(kThreads) binary_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
    uint32_t n, uint32_t a_div, uint32_t a_mod, uint32_t b_div, uint32_t b_mod) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  constexpr int N = F::N;
  uint32_t x[N], y[N], r[N];
  load_words<N>(x, a + (size_t)((i / a_div) % a_mod) * N);
  load_words<N>(y, b + (size_t)((i / b_div) % b_mod) * N);
  if (OP == kMul) {
    mont_mul<F>(r, x, y);
  } else if (OP == kAdd) {
    add_mod<F>(r, x, y);
  } else {
    sub_mod<F>(r, x, y);
  }
  store_words<N>(out + (size_t)i * N, r);
}

// out[i] = (a == b) for mode 0, (a >= b) as integers for mode 1.
template <int N>
__global__ void __launch_bounds__(kThreads) cmp_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint8_t* __restrict__ out,
    uint32_t n, uint32_t a_div, uint32_t a_mod, uint32_t b_div, uint32_t b_mod, int mode) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t* x = a + (size_t)((i / a_div) % a_mod) * N;
  const uint32_t* y = b + (size_t)((i / b_div) % b_mod) * N;
  bool eq = true, ge = true;
#pragma unroll
  for (int j = N - 1; j >= 0; j--) {  // the most significant differing word decides
    const uint32_t u = x[j], v = y[j];
    if (eq && u != v) {
      ge = u > v;
      eq = false;
    }
  }
  out[i] = mode == 0 ? (uint8_t)eq : (uint8_t)ge;
}

// x [k, inner, N] -> out [ceil(k / chunk), inner, N]: row g of out is the
// modular sum of rows g*chunk .. g*chunk+chunk-1 of x.  Neighbouring threads
// read neighbouring elements of one row, so the loads coalesce.
template <class F>
__global__ void __launch_bounds__(kThreads) sum_rows_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, uint32_t k, uint32_t inner,
    uint32_t chunk, uint32_t n_out) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_out) return;
  constexpr int N = F::N;
  const uint32_t g = t / inner, col = t % inner;
  const uint32_t lo = g * chunk;
  const uint32_t hi = min(k, lo + chunk);
  uint32_t acc[N], v[N];
  load_words<N>(acc, x + ((size_t)lo * inner + col) * N);
  for (uint32_t j = lo + 1; j < hi; j++) {
    load_words<N>(v, x + ((size_t)j * inner + col) * N);
    add_mod<F>(acc, acc, v);
  }
  store_words<N>(out + (size_t)t * N, acc);
}

inline unsigned blocks(uint32_t n) { return (n + kThreads - 1) / kThreads; }

template <class F, int OP>
int launch_binary(const void* a, const void* b, void* out, long long n, long long a_div,
                  long long a_mod, long long b_div, long long b_mod, void* stream) {
  binary_kernel<F, OP><<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (uint32_t)n, (uint32_t)a_div,
      (uint32_t)a_mod, (uint32_t)b_div, (uint32_t)b_mod);
  return (int)cudaGetLastError();
}

template <int N>
int launch_cmp(const void* a, const void* b, void* out, long long n, long long a_div,
               long long a_mod, long long b_div, long long b_mod, int mode, void* stream) {
  cmp_kernel<N><<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint8_t*)out, (uint32_t)n, (uint32_t)a_div,
      (uint32_t)a_mod, (uint32_t)b_div, (uint32_t)b_mod, mode);
  return (int)cudaGetLastError();
}

}  // namespace

#define BINARY_ENTRY(name, F, OP)                                                          \
  extern "C" int name(const void* a, const void* b, void* out, long long n, long long a_div, \
                      long long a_mod, long long b_div, long long b_mod, void* stream) {     \
    return launch_binary<F, OP>(a, b, out, n, a_div, a_mod, b_div, b_mod, stream);          \
  }

BINARY_ENTRY(kzg_fp_mont_mul, Fp, kMul)  // K1
BINARY_ENTRY(kzg_fr_mont_mul, Fr, kMul)  // K2
BINARY_ENTRY(kzg_fp_add, Fp, kAdd)
BINARY_ENTRY(kzg_fp_sub, Fp, kSub)
BINARY_ENTRY(kzg_fr_add, Fr, kAdd)
BINARY_ENTRY(kzg_fr_sub, Fr, kSub)

extern "C" int kzg_fp_cmp(const void* a, const void* b, void* out, long long n, long long a_div,
                          long long a_mod, long long b_div, long long b_mod, int mode,
                          void* stream) {
  return launch_cmp<12>(a, b, out, n, a_div, a_mod, b_div, b_mod, mode, stream);
}

extern "C" int kzg_fr_cmp(const void* a, const void* b, void* out, long long n, long long a_div,
                          long long a_mod, long long b_div, long long b_mod, int mode,
                          void* stream) {
  return launch_cmp<8>(a, b, out, n, a_div, a_mod, b_div, b_mod, mode, stream);
}

extern "C" int kzg_fr_sum_rows(const void* x, void* out, long long k, long long inner,
                               long long chunk, void* stream) {
  const uint32_t n_out = (uint32_t)(((k + chunk - 1) / chunk) * inner);
  sum_rows_kernel<Fr><<<blocks(n_out), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (uint32_t)k, (uint32_t)inner, (uint32_t)chunk, n_out);
  return (int)cudaGetLastError();
}
