// Field kernels for Hopper (sm_90a): the Fp and Fr Montgomery products (K1,
// K2), their constant-exponent chains (a^e for a host constant e, one launch
// per chain), and the small elementwise launchers that share their device
// functions (modular add and sub, compare, and the modular sum along a
// leading axis).
//
// K1 replaces kzg_rust_tpu/ops/pallas_kernels.py:248 mont_mul_fp_pallas and
// K2 replaces :252 mont_mul_fr_pallas (one factory, _make_mont_mul :202).
// The chains, kzg_fp_pow_const and kzg_fr_pow_const, are K1's and K2's
// products in one launch: the JAX package runs each such chain as one jitted
// fori_loop (kzg_rust_tpu/ops/limbs.py:513 mont_pow_const).  The verify path
// launches two, the Fermat inversion d^(r-2) of the product-tree root and
// x^4096 in the barycentric formula, both over npad blobs; the chain's body
// (field.cuh pow_const) also takes the decompression square root
// rhs^((p+1)/4) inside stage 1's kzg_g1_decompress (stage1_kernels.cu).
//
// What bounds them at the path's shapes, and what the design does about it.
// - Bytes, at K2's wide product-tree levels and barycentric terms (up to
//   16.7M elements, 537 MB an operand at n = 4096): a product is ~600
//   (Fp) or ~272 (Fr) 32-bit multiply-adds against 144 or 96 bytes, which on
//   this card is close to its bytes-to-multiply-add balance.  Each thread
//   loads and stores its element with 16-byte accesses (3 for Fp, 2 for Fr),
//   so a warp's accesses cover whole sectors and the L1 serves the rest of
//   each line, where word-by-word loads touched a sector per thread and word.
// - Launch latency, at the 64- to 8192-element launches that are most of
//   the path's products: a launch costs the host a wrapper call and the card
//   a few microseconds whatever its width.  The chains, which were 832 of
//   the ~950 launches of a batch, are one launch each.
// - Inside a chain, the latency of one dependent product: every squaring
//   waits for the last.  The element stays in registers from the first
//   product to the last; 80% of the chains' products are squarings, which
//   take the SOS squaring (field.cuh sos_sqr: the cross products once) at
//   ~0.8 of a product's instructions; and the products run on the
//   carry-chain cores (field.cuh cios_mul).
// The tensor cores, TMA and wgmma are not used: every element is a different
// multi-word integer, so no tile is shared across rows for a matrix product
// to reuse, and each block moves a few kilobytes once, which 16-byte loads
// already do at full rate.  The TPU kernel's devices (12-bit limbs, int8
// Toeplitz REDC on the MXU, roll-and-mask shifts, carry lookahead) answer a
// machine without a 32-bit multiplier and are not carried over.
//
// Operand indexing of the binary launchers: element i of the output reads
// element (i / div) % mod of each input, which covers a full operand (div 1,
// mod n), a broadcast scalar (mod 1) and a broadcast row or column of a 2-D
// batch, so callers never materialise a broadcast copy.  Operands and
// outputs of the binary launchers and the chains start on 16 bytes: the
// Python wrappers (ops/limbs.py _check_aligned) raise otherwise.
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
    const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out,
    uint32_t n, uint32_t a_div, uint32_t a_mod, uint32_t b_div, uint32_t b_mod) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  constexpr int N = F::N, V = N / 4;
  uint32_t x[N], y[N], r[N];
  load_vec<N>(x, a + (size_t)((i / a_div) % a_mod) * V);
  load_vec<N>(y, b + (size_t)((i / b_div) % b_mod) * V);
  if (OP == kMul) {
    cios_mul<F>(r, x, y);
  } else if (OP == kAdd) {
    add_mod<F>(r, x, y);
  } else {
    sub_mod<F>(r, x, y);
  }
  store_vec<N>(out + (size_t)i * V, r);
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

// out[i] = a[i]^e in Montgomery form, one thread per element (field.cuh
// pow_const: the table a^1..a^top in this thread's column of shared memory,
// then four squarings and a product a digit).  Every thread reads and writes
// only its own table column, so the block never synchronises and a thread
// past n returns at once.
template <class F, int T>
__global__ void __launch_bounds__(T) pow_kernel(const uint4* __restrict__ a,
                                                uint4* __restrict__ out, uint32_t n,
                                                const __grid_constant__ PowDigits e) {
  extern __shared__ uint32_t table[];
  const uint32_t i = blockIdx.x * T + threadIdx.x;
  if (i >= n) return;
  constexpr int N = F::N, V = N / 4;
  uint32_t x[N], acc[N];
  load_vec<N>(x, a + (size_t)i * V);
  pow_const<F, T>(acc, x, table + threadIdx.x, e);
  store_vec<N>(out + (size_t)i * V, acc);
}

inline unsigned blocks(uint32_t n) { return (n + kThreads - 1) / kThreads; }

template <class F, int OP>
int launch_binary(const void* a, const void* b, void* out, long long n, long long a_div,
                  long long a_mod, long long b_div, long long b_mod, void* stream) {
  binary_kernel<F, OP><<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (uint4*)out, (uint32_t)n, (uint32_t)a_div,
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

// A block of T threads takes top N words of shared memory a thread: 92,160
// bytes for Fp at T = 128 and 15 entries, above the 48 KB that a launch gets
// without the kernel's opt-in.  The opt-in is a function attribute of the
// current device's context, so it is set at every launch, to what this one
// needs (a host call, next to a chain of a few hundred microseconds).
template <class F, int T>
int launch_pow_t(const void* a, void* out, long long n, const PowDigits& e, cudaStream_t s) {
  const size_t smem = (size_t)e.top * F::N * 4 * T;
  const cudaError_t opt_in =
      cudaFuncSetAttribute(pow_kernel<F, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  pow_kernel<F, T><<<(unsigned)((n + T - 1) / T), T, smem, s>>>((const uint4*)a, (uint4*)out,
                                                              (uint32_t)n, e);
  return (int)cudaGetLastError();
}

template <class F>
int launch_pow(const void* a, void* out, long long n, const void* digits, long long count,
               void* stream) {
  if (count < 1 || count > kPowMaxDigits) return (int)cudaErrorInvalidValue;
  PowDigits e{};
  e.count = (uint32_t)count;
  for (long long k = 0; k < count; k++) {
    e.d[k] = ((const uint8_t*)digits)[k];
    if (e.d[k] > kPowMaxEntry) return (int)cudaErrorInvalidValue;
    e.top = e.d[k] > e.top ? e.d[k] : e.top;
  }
  if (e.d[0] == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block_threads(n)) {
    case 128: return launch_pow_t<F, 128>(a, out, n, e, s);
    case 64: return launch_pow_t<F, 64>(a, out, n, e, s);
    default: return launch_pow_t<F, 32>(a, out, n, e, s);
  }
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

#define POW_ENTRY(name, F)                                                                 \
  extern "C" int name(const void* a, void* out, long long n, const void* digits,          \
                      long long count, void* stream) {                                    \
    return launch_pow<F>(a, out, n, digits, count, stream);                               \
  }

POW_ENTRY(kzg_fp_pow_const, Fp)  // K1's chain: digits on the host, count of them
POW_ENTRY(kzg_fr_pow_const, Fr)  // K2's chain

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
