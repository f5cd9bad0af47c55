// BLS12-381 field arithmetic for Hopper (sm_90a): device functions shared
// by the field kernels (field_kernels.cu) and the G1 kernels
// (curve_kernels.cu).
//
// An element of Fp is 12 little-endian 32-bit words, one of Fr 8 words, held
// in registers by one thread.  Montgomery products use R = 2^384 for Fp (the
// same radix as the JAX package's 32 x 12-bit limbs, so Fp Montgomery values
// are the same integers in both packages) and R = 2^256 for Fr (the JAX
// package uses 2^264: its Fr Montgomery values differ by 2^8).  Every
// function takes and returns canonical values (< modulus).
//
// The word products accumulate in 64 bits: (2^32-1)^2 + 2 (2^32-1) < 2^64, so
// a * b + t + carry never overflows.  ptxas lowers each to IMAD.WIDE.U32.

#pragma once

#include <cstdint>

namespace kzg {

// Constants are checked against the golden field by the CPU tests
// (tests/test_torch_limbs.py parses this file).
static __constant__ uint32_t FP_MOD[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
static __constant__ uint32_t FR_MOD[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// 3 * b = 12 for y^2 = x^3 + 4, in Montgomery form (12 * 2^384 mod p).
static __constant__ uint32_t FP_B3_MONT[12] = {
    0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au, 0x4a6e8b59u, 0x6f7ee9ceu,
    0xc0a95bc6u, 0xb10330b7u, 0xfb1e54b7u, 0x6140b1fcu, 0x7f0bb4e1u, 0x0381be09u};

struct Fp {
  static constexpr int N = 12;
  static constexpr uint32_t INV = 0xfffcfffdu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ uint32_t mod(int i) { return FP_MOD[i]; }
};

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xffffffffu;  // -r^-1 mod 2^32
  static __device__ __forceinline__ uint32_t mod(int i) { return FR_MOD[i]; }
};

// r = t - mod if t (with high word hi) >= mod, else t.  Needs t < 2 mod.
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* t, uint32_t hi) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    uint64_t s = (uint64_t)t[j] - F::mod(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = (hi != 0) | (borrow == 0);
#pragma unroll
  for (int j = 0; j < F::N; j++) r[j] = ge ? d[j] : t[j];
}

// a * b * 2^(-32N) mod m, CIOS (Koc, Acar and Kaliski 1996): one pass of the
// word product and one of the reduction per word of b.  a, b < m give t < 2m
// after every pass, so one conditional subtract ends it.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      const uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::INV;
    s = (uint64_t)m * F::mod(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * F::mod(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<F>(r, t, t[N]);
}

template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[F::N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<F>(r, s, (uint32_t)c);
}

template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t d[F::N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    const uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add m back exactly when a < b
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < F::N; j++) {
    c += (uint64_t)d[j] + (F::mod(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

template <int N>
__device__ __forceinline__ void load_words(uint32_t* r, const uint32_t* __restrict__ src) {
#pragma unroll
  for (int j = 0; j < N; j++) r[j] = src[j];
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst, const uint32_t* r) {
#pragma unroll
  for (int j = 0; j < N; j++) dst[j] = r[j];
}

}  // namespace kzg
