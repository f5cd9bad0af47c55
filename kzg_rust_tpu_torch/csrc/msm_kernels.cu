// The fixed-base GLV MSM of the prover for Hopper (sm_90a): the scalar
// recoding (M1) and the digit-selected mixed-add accumulation over the
// affine window table (M2), plus the mixed add alone as a launcher.
//
// M1, kzg_glv_digits, replaces the XLA program of the JAX package's
// kzg_rust_tpu/ops/msm.py:187 glv_digits_from_limbs (with glv_decompose_limbs
// :133 and _digits_base32 :165).  M2, kzg_msm_glv_accumulate, replaces the
// gather of :202 _msm_core_glv and the masked mixed-add scan of
// kzg_rust_tpu/ops/curve.py:350 fold_reduce_mixed.  The JAX package never
// wrote either in Pallas; the TPU ran them as XLA programs.
//
// M1.  One thread per scalar k (canonical Fr, 8 words): the device GLV split
// of glv.py, m1 = floor(k G1C / 2^264) (a 8 x 5-word product, shifted by 8
// words and 8 bits), m2' = [k >= (r + 1) / 2], k1 = k - (m1 z^2 + m2') and
// k2 = m2' (z^2 - 1) - m1, both below 2^128 in magnitude, then the signed
// base-32 recoding of each magnitude (26 digits in [-16, 16], a digit above
// 16 borrows from the next window) with the sign folded in.  The same
// integers as the JAX program, so the same digits.  Bound: bytes (32 in,
// 52 out a scalar); the work is a few hundred multiply-adds a scalar.
//
// M2.  Thread t owns column t of the 52 N selections s = t, t + F, t + 2F,
// ..., s = (half * 26 + window) * N + point, the layout of the digits
// [2, 26, N].  For each selection with a nonzero digit d and a base that is
// not infinity it loads the affine entry table[window, |d| - 1, point]
// directly (the JAX package's one-hot masked reduction over the 16 multiples
// answered XLA's slow gather on the TPU and is not carried over), negates Y
// for d < 0, multiplies X by beta for the phi half (the GLV endomorphism
// phi(x, y) = (beta x, y) commutes with the multiples), and mixed-adds it
// onto its accumulator, which starts at infinity.  It writes F projective
// partial sums [F, 3, 12]; curve.sum_points (K3) folds them to one point.
// Bound: operations, 11 Fp products a selection (12 in the phi half) at
// ~600 32-bit multiply-adds each, against 96 bytes of table read; but each
// column runs its ~52 N / F dependent adds one after another, so the kernel
// is latency-bound: F is the card's resident thread count (chosen by the
// caller, ops/msm.py), so that one wave covers every column.
//
// What the design does about it.  Everything lives in registers: the
// accumulator and the entry are 60 words, and the formula's temporaries die
// at their last use (curve.cuh add_mixed).  Neighbouring threads take
// neighbouring points of one window, so their digit and mask loads
// coalesce; their table entries are 96-byte rows at different multiples,
// three sectors each.  Tensor cores and TMA have nothing to offer: every
// operand is a different 12-word integer.
//
// C interface as in field_kernels.cu: launch on the given stream, return
// cudaGetLastError().  Point and scalar operands start on 16 bytes (the
// entry points return cudaErrorInvalidValue otherwise).

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace kzg;

namespace {

constexpr int kWindows = 26;    // signed base-32 windows of a 128-bit GLV half
constexpr int kMultiples = 16;  // |d| in 1..16
constexpr int kPointVecs = 9;   // 16-byte vectors of a projective point
constexpr int kEntryVecs = 6;   // of an affine table entry (X, Y)

// The GLV constants of glv.py (checked against it by the CPU tests, which
// parse this file): G1C = round((z^2 - 1) 2^264 / r), z^2, z^2 - 1 and
// ceil(r / 2), as little-endian 32-bit words.
__device__ __forceinline__ constexpr uint32_t g1c_word(int j) {
  constexpr uint32_t w[5] = {0xcfee2e03u, 0xf6e522f6u, 0x1faadd63u, 0x6becf1e0u, 0x0000017cu};
  return w[j];
}
__device__ __forceinline__ constexpr uint32_t z2_word(int j) {
  constexpr uint32_t w[4] = {0x00000000u, 0x00000001u, 0x0001a402u, 0xac45a401u};
  return w[j];
}
__device__ __forceinline__ constexpr uint32_t z2m1_word(int j) {
  constexpr uint32_t w[4] = {0xffffffffu, 0x00000000u, 0x0001a402u, 0xac45a401u};
  return w[j];
}
__device__ __forceinline__ constexpr uint32_t half_r_word(int j) {
  constexpr uint32_t w[8] = {0x80000001u, 0x7fffffffu, 0x7fff2dffu, 0xa9ded201u,
                             0x04d0ec02u, 0x199cec04u, 0x94cebea4u, 0x39f6d3a9u};
  return w[j];
}
// beta (a primitive cube root of unity in Fp) and 1, in Montgomery form
// (curve.py BETA_MONT, limbs.FP.mont_r).
__device__ __forceinline__ constexpr uint32_t beta_mont_word(int j) {
  constexpr uint32_t w[12] = {0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu,
                              0xc61577f7u, 0x16a8ca3au, 0x74fd029bu, 0xc26a2ff8u,
                              0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu};
  return w[j];
}
__device__ __forceinline__ constexpr uint32_t one_mont_word(int j) {
  constexpr uint32_t w[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
                              0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
                              0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
  return w[j];
}

// r[0..A+B-1] = a[0..A-1] * b[0..B-1], schoolbook on 64-bit partial sums.
template <int A, int B>
__device__ __forceinline__ void mul_words(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int j = 0; j < A + B; j++) r[j] = 0;
#pragma unroll
  for (int i = 0; i < A; i++) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < B; j++) {
      const uint64_t t = (uint64_t)a[i] * b[j] + r[i + j] + carry;
      r[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    r[i + B] = (uint32_t)carry;
  }
}

// d = a - b over L words; returns the borrow out (1 when a < b), d = a - b + 2^(32 L).
template <int L>
__device__ __forceinline__ uint32_t sub_words(uint32_t* d, const uint32_t* a, const uint32_t* b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const uint64_t t = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  return (uint32_t)borrow;
}

// x = 2^(32 L) - x (the magnitude of a negative L-word two's complement).
template <int L>
__device__ __forceinline__ void negate_words(uint32_t* x) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; j++) {
    const uint64_t t = 0ull - x[j] - borrow;
    x[j] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
}

// The 26 signed base-32 digits of a magnitude below 2^130 (words 0..4, word
// 5 zero), times sign, to out[0], out[stride], ...
__device__ __forceinline__ void recode32(const uint32_t* mag, bool neg, int8_t* out, uint32_t stride) {
  int carry = 0;
#pragma unroll
  for (int j = 0; j < kWindows; j++) {
    const int bit = 5 * j, word = bit >> 5, off = bit & 31;
    uint32_t raw = mag[word] >> off;
    if (off > 27) raw |= mag[word + 1] << (32 - off);
    const int d = (int)(raw & 31u) + carry;
    carry = d > 16;
    const int digit = d - 32 * carry;
    out[(size_t)j * stride] = (int8_t)(neg ? -digit : digit);
  }
}

// M1: k [m, 8] canonical Fr -> digits [2, 26, m] int8 (half 0: k1, half 1: k2).
__global__ void __launch_bounds__(128) glv_digits_kernel(const uint4* __restrict__ scalars,
                                                        int8_t* __restrict__ out, uint32_t m) {
  const uint32_t i = blockIdx.x * 128 + threadIdx.x;
  if (i >= m) return;
  uint32_t k[8];
  load_vec<8>(k, scalars + (size_t)i * 2);

  uint32_t g1c[5], z2[4];
#pragma unroll
  for (int j = 0; j < 5; j++) g1c[j] = g1c_word(j);
#pragma unroll
  for (int j = 0; j < 4; j++) z2[j] = z2_word(j);

  // m1 = floor(k G1C / 2^264): k G1C < 2^392, so m1 < 2^128.
  uint32_t prod[13], m1[4];
  mul_words<8, 5>(prod, k, g1c);
#pragma unroll
  for (int j = 0; j < 4; j++) m1[j] = (prod[8 + j] >> 8) | (prod[9 + j] << 24);

  // m2' = [k >= ceil(r / 2)]: the most significant differing word decides.
  bool ge = true, eq = true;
#pragma unroll
  for (int j = 7; j >= 0; j--) {
    if (eq && k[j] != half_r_word(j)) {
      ge = k[j] > half_r_word(j);
      eq = false;
    }
  }
  const uint32_t m2 = ge ? 1u : 0u;

  // k1 = k - (m1 z^2 + m2'), with u = m1 z^2 + m2' < k + 2^120 < 2^256 and
  // |k1| < 2^128: the 8-word difference is exact in two's complement.
  uint32_t u[8], mag1[6], mag2[6];
  mul_words<4, 4>(u, m1, z2);
  uint64_t c = m2;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += u[j];
    u[j] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t d1[8];
  const bool neg1 = sub_words<8>(d1, k, u);
  if (neg1) negate_words<8>(d1);
  // k2 = m2' (z^2 - 1) - m1: both terms below 2^128, so 4 words suffice.
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; j++) v[j] = m2 ? z2m1_word(j) : 0u;
  uint32_t d2[4];
  const bool neg2 = sub_words<4>(d2, v, m1);
  if (neg2) negate_words<4>(d2);
#pragma unroll
  for (int j = 0; j < 6; j++) {
    mag1[j] = j < 5 ? d1[j] : 0u;
    mag2[j] = j < 4 ? d2[j] : 0u;
  }
  recode32(mag1, neg1, out + i, m);
  recode32(mag2, neg2, out + (size_t)kWindows * m + i, m);
}

// M2: see the head of the file.  table [26, 16, n, 2, 12], inf [n] (0 or 1),
// digits [2, 26, n] -> out [folds, 3, 12].
template <int T>
__global__ void __launch_bounds__(T) msm_glv_accumulate_kernel(
    const uint4* __restrict__ table, const uint8_t* __restrict__ inf,
    const int8_t* __restrict__ digits, uint4* __restrict__ out, uint32_t n, uint32_t folds) {
  const uint32_t t = blockIdx.x * T + threadIdx.x;
  if (t >= folds) return;
  Elt zero, one, beta;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) {
    zero.w[j] = 0;
    one.w[j] = one_mont_word(j);
    beta.w[j] = beta_mont_word(j);
  }
  Elt X = zero, Y = one, Z = zero;  // infinity
  const uint32_t total = 2u * kWindows * n;
  for (uint32_t s = t; s < total; s += folds) {
    const int d = digits[s];
    const uint32_t i = s % n;
    if (d == 0 || inf[i]) continue;
    const uint32_t hw = s / n;  // half * 26 + window
    const uint32_t w = hw % kWindows;
    const uint32_t mag = d < 0 ? -d : d;
    const uint4* e = table + ((size_t)(w * kMultiples + mag - 1) * n + i) * kEntryVecs;
    Elt x = ldg(e);
    Elt y = ldg(e + 3);
    if (hw >= kWindows) x = mul(x, beta);
    if (d < 0) y = sub(zero, y);
    add_mixed(X, Y, Z, x, y);
  }
  uint4* o = out + (size_t)t * kPointVecs;
  stg(o, X);
  stg(o + 3, Y);
  stg(o + 6, Z);
}

// The mixed add alone: out[i] = p[i] + q[i], p [n, 3, 12] projective, q
// [n, 2, 12] affine (not infinity).
__global__ void __launch_bounds__(128) proj_add_mixed_kernel(
    const uint4* __restrict__ p, const uint4* __restrict__ q, uint4* __restrict__ out, uint32_t n) {
  const uint32_t i = blockIdx.x * 128 + threadIdx.x;
  if (i >= n) return;
  const uint4* a = p + (size_t)i * kPointVecs;
  const uint4* b = q + (size_t)i * kEntryVecs;
  Elt X = ldg(a), Y = ldg(a + 3), Z = ldg(a + 6);
  add_mixed(X, Y, Z, ldg(b), ldg(b + 3));
  uint4* o = out + (size_t)i * kPointVecs;
  stg(o, X);
  stg(o + 3, Y);
  stg(o + 6, Z);
}

bool aligned(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

unsigned blocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

template <int T>
void launch_accumulate(const void* table, const void* inf, const void* digits, void* out,
                       long long n, long long folds, cudaStream_t s) {
  msm_glv_accumulate_kernel<T><<<blocks(folds, T), T, 0, s>>>(
      (const uint4*)table, (const uint8_t*)inf, (const int8_t*)digits, (uint4*)out,
      (uint32_t)n, (uint32_t)folds);
}

}  // namespace

extern "C" int kzg_glv_digits(const void* scalars, void* out, long long m, void* stream) {  // M1
  if (!aligned(scalars)) return (int)cudaErrorInvalidValue;
  glv_digits_kernel<<<blocks(m, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)scalars, (int8_t*)out, (uint32_t)m);
  return (int)cudaGetLastError();
}

extern "C" int kzg_msm_glv_accumulate(const void* table, const void* inf, const void* digits,
                                      void* out, long long n, long long folds,
                                      void* stream) {  // M2
  if (!aligned(table) || !aligned(out)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block_threads(folds)) {
    case 128: launch_accumulate<128>(table, inf, digits, out, n, folds, s); break;
    case 64: launch_accumulate<64>(table, inf, digits, out, n, folds, s); break;
    default: launch_accumulate<32>(table, inf, digits, out, n, folds, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_proj_add_mixed(const void* p, const void* q, void* out, long long n,
                                  void* stream) {
  if (!aligned(p) || !aligned(q) || !aligned(out)) return (int)cudaErrorInvalidValue;
  proj_add_mixed_kernel<<<blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)p, (const uint4*)q, (uint4*)out, (uint32_t)n);
  return (int)cudaGetLastError();
}
