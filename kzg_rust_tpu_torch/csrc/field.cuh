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

// ---------------------------------------------------------------------------
// The Fp core of the curve kernels (curve_kernels.cu): the same functions on
// Hopper's 32-bit carry chains (add.cc / addc.cc / sub.cc in PTX) and its
// 32 x 32 -> 64-bit multiply (mul.wide.u32, one IMAD.WIDE.U32).  Each carry
// chain is one asm block, so nothing the compiler schedules can land between
// two links of a chain and clobber the carry flag.  mont_mul above stays as
// it is for K1 and K2.
//
// Instructions per Fp product in the SASS of sm_90a (cuobjdump -sass of
// chip_smoke.py's probe kernels; H100 run in PERF.md): mont_mul<Fp> above
// 1,113, fp_mont_mul below 902.  A row a * b[i] is 12 IMAD.WIDE.U32 and two
// 12-link IADD3.X chains (low and high words), with no 64-bit adds; the
// first version, mad.lo.cc / madc.hi.cc chains, took 1,202, because ptxas
// splits each such link into an IMAD or IMAD.HI and an IADD3.X.
// ---------------------------------------------------------------------------

// Word j of p as an immediate, so the rows take the modulus without
// registers (FP_MOD above stays in constant memory for K1 and K2).
__device__ __forceinline__ constexpr uint32_t fp_mod_word(int j) {
  constexpr uint32_t w[12] = {
      0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
      0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return w[j];
}

// t[0..12] += a * b: twelve 32 x 32 -> 64-bit products (IMAD.WIDE.U32),
// their low words along one carry chain into t[0..11] (the carry out into
// t[12]) and their high words along another into t[1..12].  The caller's
// bound (the running sum stays below 2^416) leaves no carry out of t[12].
__device__ __forceinline__ void fp_mad_row(uint32_t* t, const uint32_t* a, uint32_t b) {
  asm volatile(
      "{\n\t"
      ".reg .u64 w<12>;\n\t"
      ".reg .u32 l<12>, h<12>;\n\t"
      "mul.wide.u32 w0, %13, %25;\n\t"
      "mul.wide.u32 w1, %14, %25;\n\t"
      "mul.wide.u32 w2, %15, %25;\n\t"
      "mul.wide.u32 w3, %16, %25;\n\t"
      "mul.wide.u32 w4, %17, %25;\n\t"
      "mul.wide.u32 w5, %18, %25;\n\t"
      "mul.wide.u32 w6, %19, %25;\n\t"
      "mul.wide.u32 w7, %20, %25;\n\t"
      "mul.wide.u32 w8, %21, %25;\n\t"
      "mul.wide.u32 w9, %22, %25;\n\t"
      "mul.wide.u32 w10, %23, %25;\n\t"
      "mul.wide.u32 w11, %24, %25;\n\t"
      "mov.b64 {l0, h0}, w0;\n\t"
      "mov.b64 {l1, h1}, w1;\n\t"
      "mov.b64 {l2, h2}, w2;\n\t"
      "mov.b64 {l3, h3}, w3;\n\t"
      "mov.b64 {l4, h4}, w4;\n\t"
      "mov.b64 {l5, h5}, w5;\n\t"
      "mov.b64 {l6, h6}, w6;\n\t"
      "mov.b64 {l7, h7}, w7;\n\t"
      "mov.b64 {l8, h8}, w8;\n\t"
      "mov.b64 {l9, h9}, w9;\n\t"
      "mov.b64 {l10, h10}, w10;\n\t"
      "mov.b64 {l11, h11}, w11;\n\t"
      "add.cc.u32  %0, %0, l0;\n\t"
      "addc.cc.u32 %1, %1, l1;\n\t"
      "addc.cc.u32 %2, %2, l2;\n\t"
      "addc.cc.u32 %3, %3, l3;\n\t"
      "addc.cc.u32 %4, %4, l4;\n\t"
      "addc.cc.u32 %5, %5, l5;\n\t"
      "addc.cc.u32 %6, %6, l6;\n\t"
      "addc.cc.u32 %7, %7, l7;\n\t"
      "addc.cc.u32 %8, %8, l8;\n\t"
      "addc.cc.u32 %9, %9, l9;\n\t"
      "addc.cc.u32 %10, %10, l10;\n\t"
      "addc.cc.u32 %11, %11, l11;\n\t"
      "addc.u32    %12, %12, 0;\n\t"
      "add.cc.u32  %1, %1, h0;\n\t"
      "addc.cc.u32 %2, %2, h1;\n\t"
      "addc.cc.u32 %3, %3, h2;\n\t"
      "addc.cc.u32 %4, %4, h3;\n\t"
      "addc.cc.u32 %5, %5, h4;\n\t"
      "addc.cc.u32 %6, %6, h5;\n\t"
      "addc.cc.u32 %7, %7, h6;\n\t"
      "addc.cc.u32 %8, %8, h7;\n\t"
      "addc.cc.u32 %9, %9, h8;\n\t"
      "addc.cc.u32 %10, %10, h9;\n\t"
      "addc.cc.u32 %11, %11, h10;\n\t"
      "addc.u32    %12, %12, h11;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
}

// r = t - p if t >= p, else t.  Needs t < 2p.
__device__ __forceinline__ void fp_reduce_once(uint32_t* r, const uint32_t* t) {
  uint32_t d[12], borrow;
#pragma unroll
  for (int j = 0; j < 12; j++) d[j] = t[j];
  asm volatile(
      "sub.cc.u32  %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32    %12, 0, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "=r"(borrow)
      : "r"(fp_mod_word(0)), "r"(fp_mod_word(1)), "r"(fp_mod_word(2)), "r"(fp_mod_word(3)),
        "r"(fp_mod_word(4)), "r"(fp_mod_word(5)), "r"(fp_mod_word(6)), "r"(fp_mod_word(7)),
        "r"(fp_mod_word(8)), "r"(fp_mod_word(9)), "r"(fp_mod_word(10)), "r"(fp_mod_word(11)));
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = borrow ? t[j] : d[j];
}

// a * b * 2^-384 mod p, CIOS as mont_mul above: per word b[i], the row
// a * b[i] and the row m * p, then a one-word shift (a renaming, no
// instructions).  With t < 2p on entry to a
// row, t + a b[i] + m p < 2p + 2^33 p < 2^416 fits t[0..12], and the shifted
// t stays < 2p, so one conditional subtract ends it.
__device__ __forceinline__ void fp_mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[13], p[12];
#pragma unroll
  for (int j = 0; j < 13; j++) t[j] = 0;
#pragma unroll
  for (int j = 0; j < 12; j++) p[j] = fp_mod_word(j);
#pragma unroll
  for (int i = 0; i < 12; i++) {
    fp_mad_row(t, a, b[i]);
    const uint32_t m = t[0] * Fp::INV;
    fp_mad_row(t, p, m);
#pragma unroll
    for (int j = 0; j < 12; j++) t[j] = t[j + 1];
    t[12] = 0;
  }
  fp_reduce_once(r, t);
}

// a + b mod p for a, b < p: the sum is below 2^383, so no carry leaves the chain.
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[12];
#pragma unroll
  for (int j = 0; j < 12; j++) s[j] = a[j];
  asm volatile(
      "add.cc.u32  %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32    %11, %11, %23;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]),
        "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
        "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  fp_reduce_once(r, s);
}

// a - b mod p for a, b < p: subtract, then add p back (masked by the borrow);
// the second chain's carry out is the 2^384 the borrow lent.
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t borrow;
#pragma unroll
  for (int j = 0; j < 12; j++) r[j] = a[j];
  asm volatile(
      "sub.cc.u32  %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32    %12, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]), "+r"(r[11]), "=r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]),
        "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  asm volatile(
      "add.cc.u32  %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32    %11, %11, %23;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "+r"(r[8]), "+r"(r[9]), "+r"(r[10]), "+r"(r[11])
      : "r"(fp_mod_word(0) & borrow), "r"(fp_mod_word(1) & borrow), "r"(fp_mod_word(2) & borrow),
        "r"(fp_mod_word(3) & borrow), "r"(fp_mod_word(4) & borrow), "r"(fp_mod_word(5) & borrow),
        "r"(fp_mod_word(6) & borrow), "r"(fp_mod_word(7) & borrow), "r"(fp_mod_word(8) & borrow),
        "r"(fp_mod_word(9) & borrow), "r"(fp_mod_word(10) & borrow),
        "r"(fp_mod_word(11) & borrow));
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
