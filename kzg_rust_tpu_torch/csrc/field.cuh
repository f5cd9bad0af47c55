// BLS12-381 field arithmetic for Hopper (sm_90a): device functions shared
// by the field kernels (field_kernels.cu), the G1 kernels (curve_kernels.cu,
// msm_kernels.cu) and stage 1's kernels (stage1_kernels.cu), and the block
// size their launchers take.
//
// An element of Fp is 12 little-endian 32-bit words, one of Fr 8 words, held
// in registers by one thread.  Montgomery products use R = 2^384 for Fp (the
// same radix as the JAX package's 32 x 12-bit limbs, so Fp Montgomery values
// are the same integers in both packages) and R = 2^256 for Fr (the JAX
// package uses 2^264: its Fr Montgomery values differ by 2^8).  Every
// function takes and returns canonical values (< modulus), but the lane
// product lane_mul (values below 2p, for kernel A's chain).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace kzg {

// Word j of p and of r, as immediates: every kernel takes the modulus
// without loads.  Checked against the golden field by the CPU tests
// (tests/test_torch_limbs.py parses this file).
__device__ __forceinline__ constexpr uint32_t fp_mod_word(int j) {
  constexpr uint32_t w[12] = {
      0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
      0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return w[j];
}

__device__ __forceinline__ constexpr uint32_t fr_mod_word(int j) {
  constexpr uint32_t w[8] = {
      0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
      0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
  return w[j];
}

struct Fp {
  static constexpr int N = 12;
  static constexpr uint32_t INV = 0xfffcfffdu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ constexpr uint32_t mod(int i) { return fp_mod_word(i); }
};

struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t INV = 0xffffffffu;  // -r^-1 mod 2^32
  static __device__ __forceinline__ constexpr uint32_t mod(int i) { return fr_mod_word(i); }
};

// ---------------------------------------------------------------------------
// The arithmetic of every kernel (K1 and K2 and the small launchers in
// field_kernels.cu, K3 and K4 in curve_kernels.cu): Hopper's 32-bit carry
// chains (add.cc / addc.cc / sub.cc in PTX) and its 32 x 32 -> 64-bit
// multiply (mul.wide.u32, one IMAD.WIDE.U32).  Each carry chain is one asm
// block, so nothing the compiler schedules can land between two links of a
// chain and clobber the carry flag.  One modular add, sub and final subtract
// per field: add_mod<F>, sub_mod<F> and reduce_once<F> pick it.
//
// Instructions per call in the SASS of sm_90a (cuobjdump -sass of
// chip_smoke.py's probe kernels, less a probe that only loads and stores;
// H100 run in PERF.md): fp_mont_mul 902, fp_mont_sqr 767,
// fr_mont_mul 410, fr_mont_sqr 366.  The first core, 64-bit C arithmetic
// (one IMAD.WIDE.U32 and 64-bit adds a word product), took 1,113 for an Fp
// product; mad.lo.cc / madc.hi.cc chains took 1,202, because ptxas splits
// each such link into an IMAD or IMAD.HI and an IADD3.X.
// ---------------------------------------------------------------------------

// The text of one multiply-add row of L words.  Operands: %0..%12 the window
// t, %13..%24 the words of a, %25 the word b; a row of L < 12 words leaves the
// operands past its length unreferenced.  The L products a[j] * b are split
// into low and high words; the low words go along one carry chain into
// t[0..L-1] (its carry into t[L]), the high words along another into t[1..L].
#define KZG_MUL(j, aj, j1) \
  "mul.wide.u32 w" #j ", %" #aj ", %25;\n\tmov.b64 {l" #j ", h" #j "}, w" #j ";\n\t"
#define KZG_LO(j, aj, j1) "addc.cc.u32 %" #j ", %" #j ", l" #j ";\n\t"
#define KZG_HI(j, aj, j1) "addc.cc.u32 %" #j1 ", %" #j1 ", h" #j ";\n\t"
// KZG_FROM1_n(M): M(j, 13 + j, j + 1) for j = 1 .. n - 1.
#define KZG_FROM1_0(M)
#define KZG_FROM1_1(M)
#define KZG_FROM1_2(M) M(1, 14, 2)
#define KZG_FROM1_3(M) KZG_FROM1_2(M) M(2, 15, 3)
#define KZG_FROM1_4(M) KZG_FROM1_3(M) M(3, 16, 4)
#define KZG_FROM1_5(M) KZG_FROM1_4(M) M(4, 17, 5)
#define KZG_FROM1_6(M) KZG_FROM1_5(M) M(5, 18, 6)
#define KZG_FROM1_7(M) KZG_FROM1_6(M) M(6, 19, 7)
#define KZG_FROM1_8(M) KZG_FROM1_7(M) M(7, 20, 8)
#define KZG_FROM1_9(M) KZG_FROM1_8(M) M(8, 21, 9)
#define KZG_FROM1_10(M) KZG_FROM1_9(M) M(9, 22, 10)
#define KZG_FROM1_11(M) KZG_FROM1_10(M) M(10, 23, 11)
#define KZG_FROM1_12(M) KZG_FROM1_11(M) M(11, 24, 12)
#define KZG_ROW_DECL "{\n\t.reg .u64 w<12>;\n\t.reg .u32 l<12>, h<12>;\n\t"
#define KZG_ROW_TEXT(L, Lm1)                                                      \
  KZG_ROW_DECL KZG_MUL(0, 13, 1) KZG_FROM1_##L(KZG_MUL)                           \
  "add.cc.u32 %0, %0, l0;\n\t" KZG_FROM1_##L(KZG_LO)                              \
  "addc.u32 %" #L ", %" #L ", 0;\n\t"                                             \
  "add.cc.u32 %1, %1, h0;\n\t" KZG_FROM1_##Lm1(KZG_HI)                            \
  "addc.u32 %" #L ", %" #L ", h" #Lm1 ";\n\t}"
#define KZG_ROW_TEXT_1                                                            \
  KZG_ROW_DECL KZG_MUL(0, 13, 1) "add.cc.u32 %0, %0, l0;\n\taddc.u32 %1, %1, h0;\n\t}"
#define KZG_ROW_OPERANDS                                                          \
  : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),       \
    "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]), "+r"(x[10]), "+r"(x[11]),     \
    "+r"(x[12])                                                                   \
  : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]),  \
    "r"(y[7]), "r"(y[8]), "r"(y[9]), "r"(y[10]), "r"(y[11]), "r"(b)

template <int L>
__device__ __forceinline__ void mad_row_asm(uint32_t* x, const uint32_t* y, uint32_t b);

#define KZG_DEFINE_ROW(L, TEXT)                                                       \
  template <>                                                                         \
  __device__ __forceinline__ void mad_row_asm<L>(uint32_t* x, const uint32_t* y, uint32_t b) { \
    asm volatile(TEXT KZG_ROW_OPERANDS);                                              \
  }
KZG_DEFINE_ROW(1, KZG_ROW_TEXT_1)
KZG_DEFINE_ROW(2, KZG_ROW_TEXT(2, 1))
KZG_DEFINE_ROW(3, KZG_ROW_TEXT(3, 2))
KZG_DEFINE_ROW(4, KZG_ROW_TEXT(4, 3))
KZG_DEFINE_ROW(5, KZG_ROW_TEXT(5, 4))
KZG_DEFINE_ROW(6, KZG_ROW_TEXT(6, 5))
KZG_DEFINE_ROW(7, KZG_ROW_TEXT(7, 6))
KZG_DEFINE_ROW(8, KZG_ROW_TEXT(8, 7))
KZG_DEFINE_ROW(9, KZG_ROW_TEXT(9, 8))
KZG_DEFINE_ROW(10, KZG_ROW_TEXT(10, 9))
KZG_DEFINE_ROW(11, KZG_ROW_TEXT(11, 10))
KZG_DEFINE_ROW(12, KZG_ROW_TEXT(12, 11))

// t[0..L] += a[0..L-1] * b: L word products (IMAD.WIDE.U32) and two carry
// chains of L links (IADD3.X).  The caller's bound keeps the sum below
// 2^(32 (L + 1)), so no carry leaves t[L].  Rows of 12 and 8 words are the Fp
// and Fr rows of the products; the squarings' triangles take every length.
template <int L>
__device__ __forceinline__ void mad_row(uint32_t* t, const uint32_t* a, uint32_t b) {
  uint32_t x[13], y[12];
#pragma unroll
  for (int j = 0; j < 13; j++) x[j] = j <= L ? t[j] : 0u;
#pragma unroll
  for (int j = 0; j < 12; j++) y[j] = j < L ? a[j] : 0u;
  mad_row_asm<L>(x, y, b);
#pragma unroll
  for (int j = 0; j <= L; j++) t[j] = x[j];
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

// r = t - r_mod if t >= r_mod, else t.  Needs t < 2 r_mod.
__device__ __forceinline__ void fr_reduce_once(uint32_t* r, const uint32_t* t) {
  uint32_t d[8], borrow;
#pragma unroll
  for (int j = 0; j < 8; j++) d[j] = t[j];
  asm volatile(
      "sub.cc.u32  %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32    %8, 0, 0;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "=r"(borrow)
      : "r"(fr_mod_word(0)), "r"(fr_mod_word(1)), "r"(fr_mod_word(2)), "r"(fr_mod_word(3)),
        "r"(fr_mod_word(4)), "r"(fr_mod_word(5)), "r"(fr_mod_word(6)), "r"(fr_mod_word(7)));
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? t[j] : d[j];
}

// a + b mod p for a + b < 2p: the sum is below 2^383, so no carry leaves the chain.
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

// a + b mod r_mod for a + b < 2 r_mod < 2^256: no carry leaves the chain.
__device__ __forceinline__ void fr_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t s[8];
#pragma unroll
  for (int j = 0; j < 8; j++) s[j] = a[j];
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]),
        "+r"(s[7])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  fr_reduce_once(r, s);
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

// a - b mod r_mod for a, b < r_mod, as fp_sub.
__device__ __forceinline__ void fr_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t borrow;
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = a[j];
  asm volatile(
      "sub.cc.u32  %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32    %8, 0, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7]), "=r"(borrow)
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  asm volatile(
      "add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]), "+r"(r[6]),
        "+r"(r[7])
      : "r"(fr_mod_word(0) & borrow), "r"(fr_mod_word(1) & borrow), "r"(fr_mod_word(2) & borrow),
        "r"(fr_mod_word(3) & borrow), "r"(fr_mod_word(4) & borrow), "r"(fr_mod_word(5) & borrow),
        "r"(fr_mod_word(6) & borrow), "r"(fr_mod_word(7) & borrow));
}

// The field's own final subtract, modular add and modular sub, for the
// templates below and the field launchers.
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* t) {
  if constexpr (F::N == 12) fp_reduce_once(r, t); else fr_reduce_once(r, t);
}

template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  if constexpr (F::N == 12) fp_add(r, a, b); else fr_add(r, a, b);
}

template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  if constexpr (F::N == 12) fp_sub(r, a, b); else fr_sub(r, a, b);
}

// a * b * 2^(-32N) mod m, CIOS (Koc, Acar and Kaliski 1996): per word b[i],
// the row a * b[i] and the row q m with q = t[0] (-m^-1) mod 2^32, then a
// one-word shift (a renaming, no instructions).  With t < 2m on entry to a
// row, t + a b[i] + q m < 2m + 2 (2^32 - 1) m < 2^33 m, which fits the
// window t[0..N] because m < 2^(32N - 1) (p < 2^381, r < 2^255): below 2^414
// for Fp and 2^288 for Fr.  The shifted t stays < 2m, so one conditional
// subtract ends it.  a, b and r may alias.
template <class F>
__device__ __forceinline__ void cios_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t t[N + 1], m[N];
#pragma unroll
  for (int j = 0; j <= N; j++) t[j] = 0;
#pragma unroll
  for (int j = 0; j < N; j++) m[j] = F::mod(j);
#pragma unroll
  for (int i = 0; i < N; i++) {
    mad_row<N>(t, a, b[i]);
    const uint32_t q = t[0] * F::INV;
    mad_row<N>(t, m, q);
#pragma unroll
    for (int j = 0; j < N; j++) t[j] = t[j + 1];
    t[N] = 0;
  }
  reduce_once<F>(r, t);
}

// The squaring's cross products: row i adds a[i] * a[i+1..N-1] into
// T[2i+1..i+N].  After rows 0..i the sum is below 2^(32 (i+1)) a <
// 2^(32 (i+N+1)) and the words above T[i+N] are still 0, so no row carries
// out of its window.
template <int N, int... I>
__device__ __forceinline__ void cross_rows(uint32_t* T, const uint32_t* a,
                                           std::integer_sequence<int, I...>) {
  (mad_row<N - 1 - I>(T + 2 * I + 1, a + I + 1, a[I]), ...);
}

// T[0..7] += a[0]^2 + a[1]^2 2^64 + a[2]^2 2^128 + a[3]^2 2^192 + c, and c =
// the carry out.  c <= 1 enters as the addend of the first square, which
// stays below 2^64 ((2^32 - 1)^2 + 1 < 2^64).
__device__ __forceinline__ void add_squares4(uint32_t* T, const uint32_t* a, uint32_t& c) {
  asm volatile(
      "{\n\t"
      ".reg .u64 w<4>, cin;\n\t"
      ".reg .u32 l<4>, h<4>;\n\t"
      "cvt.u64.u32 cin, %8;\n\t"
      "mad.wide.u32 w0, %9, %9, cin;\n\t"
      "mul.wide.u32 w1, %10, %10;\n\t"
      "mul.wide.u32 w2, %11, %11;\n\t"
      "mul.wide.u32 w3, %12, %12;\n\t"
      "mov.b64 {l0, h0}, w0;\n\t"
      "mov.b64 {l1, h1}, w1;\n\t"
      "mov.b64 {l2, h2}, w2;\n\t"
      "mov.b64 {l3, h3}, w3;\n\t"
      "add.cc.u32  %0, %0, l0;\n\t"
      "addc.cc.u32 %1, %1, h0;\n\t"
      "addc.cc.u32 %2, %2, l1;\n\t"
      "addc.cc.u32 %3, %3, h1;\n\t"
      "addc.cc.u32 %4, %4, l2;\n\t"
      "addc.cc.u32 %5, %5, h2;\n\t"
      "addc.cc.u32 %6, %6, l3;\n\t"
      "addc.cc.u32 %7, %7, h3;\n\t"
      "addc.u32    %8, 0, 0;\n\t"
      "}"
      : "+r"(T[0]), "+r"(T[1]), "+r"(T[2]), "+r"(T[3]), "+r"(T[4]), "+r"(T[5]), "+r"(T[6]),
        "+r"(T[7]), "+r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}

// a^2 * 2^(-32N) mod m, SOS: the N (N-1)/2 cross products once (78 word
// products for Fp with the squares, against 144 for a product; 36 against
// 64 for Fr), doubled by funnel shifts (2 T < a^2 < 2^(64N), so no bit
// leaves T), the squares added along the diagonal, then the Montgomery
// reduction of the low half alone, (T_lo + q m) / 2^(32N) <= m with the same
// window and bound as cios_mul, plus the high half T_hi < m^2 / 2^(32N) < m.
// The sum is below 2m, so one conditional subtract ends it.  r may alias a.
template <class F>
__device__ __forceinline__ void sos_sqr(uint32_t* r, const uint32_t* a) {
  constexpr int N = F::N;
  uint32_t T[2 * N], t[N + 1], m[N];
#pragma unroll
  for (int j = 0; j < 2 * N; j++) T[j] = 0;
  cross_rows<N>(T, a, std::make_integer_sequence<int, N - 1>{});
#pragma unroll
  for (int j = 2 * N - 1; j > 0; j--) T[j] = __funnelshift_l(T[j - 1], T[j], 1);
  uint32_t c = 0;  // T[0] is 0: the cross products start at T[1]
#pragma unroll
  for (int k = 0; k < N; k += 4) add_squares4(T + 2 * k, a + k, c);
#pragma unroll
  for (int j = 0; j < N; j++) {
    t[j] = T[j];
    m[j] = F::mod(j);
  }
  t[N] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    const uint32_t q = t[0] * F::INV;
    mad_row<N>(t, m, q);
#pragma unroll
    for (int j = 0; j < N; j++) t[j] = t[j + 1];
    t[N] = 0;
  }
  add_mod<F>(r, t, T + N);
}

__device__ __forceinline__ void fp_mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  cios_mul<Fp>(r, a, b);
}
__device__ __forceinline__ void fr_mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  cios_mul<Fr>(r, a, b);
}
__device__ __forceinline__ void fp_mont_sqr(uint32_t* r, const uint32_t* a) { sos_sqr<Fp>(r, a); }
__device__ __forceinline__ void fr_mont_sqr(uint32_t* r, const uint32_t* a) { sos_sqr<Fr>(r, a); }

// ---------------------------------------------------------------------------
// Constant-exponent chains (K1's kzg_fp_pow_const and K2's kzg_fr_pow_const
// in field_kernels.cu; the table helpers also serve the square root of
// kzg_g1_decompress in stage1_kernels.cu, whose chain is its own).
// ---------------------------------------------------------------------------

constexpr int kPowMaxDigits = 96;  // 4-bit digits of an exponent below 2^384
constexpr int kPowMaxEntry = 15;

// The exponent of a chain, by value: its 4-bit digits, most significant
// first (d[0] != 0), and the largest digit.  A kernel parameter lives in the
// constant bank, which every thread of a warp reads at one address in one
// cycle; a CUDA graph captures it with the launch.
struct PowDigits {
  uint8_t d[kPowMaxDigits];
  uint32_t count;
  uint32_t top;
};

// Entry k (a^k, 1 <= k <= top) of this thread's table, word j, at
// col[((k - 1) N + j) T]: neighbouring threads hit neighbouring banks.
template <int N, int T>
__device__ __forceinline__ void table_put(uint32_t* col, uint32_t k, const uint32_t* v) {
  col += (k - 1) * N * T;
#pragma unroll
  for (int j = 0; j < N; j++) col[j * T] = v[j];
}

template <int N, int T>
__device__ __forceinline__ void table_get(uint32_t* v, const uint32_t* col, uint32_t k) {
  col += (k - 1) * N * T;
#pragma unroll
  for (int j = 0; j < N; j++) v[j] = col[j * T];
}

// acc = a^e in Montgomery form by one thread: the table a^1..a^top in its
// column ``col`` of the block's dynamic shared memory, laid out
// [entry][word][thread] for T threads (top N words a thread; top - 1
// products), then per further digit four squarings and, for a nonzero
// digit, one product by a table entry.  acc may alias a.
template <class F, int T>
__device__ __forceinline__ void pow_const(uint32_t* acc, const uint32_t* a, uint32_t* col,
                                          const PowDigits& e) {
  constexpr int N = F::N;
  uint32_t x[N];
#pragma unroll
  for (int j = 0; j < N; j++) x[j] = acc[j] = a[j];
  table_put<N, T>(col, 1, x);
#pragma unroll 1
  for (uint32_t k = 2; k <= e.top; k++) {
    cios_mul<F>(acc, acc, x);
    table_put<N, T>(col, k, acc);
  }
  table_get<N, T>(acc, col, e.d[0]);
#pragma unroll 1
  for (uint32_t k = 1; k < e.count; k++) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) sos_sqr<F>(acc, acc);
    const uint32_t d = e.d[k];
    if (d) {
      table_get<N, T>(x, col, d);
      cios_mul<F>(acc, acc, x);
    }
  }
}

// ---------------------------------------------------------------------------
// The Fp Montgomery product spread over L = 2 or 4 lanes of a warp (the
// square-root chain of stage1_kernels.cu kzg_g1_decompress).  A group is L
// neighbouring lanes, aligned on L; lane r of it holds W = 12 / L words of
// an element, words W r .. W r + W - 1 (its "part").  Every lane of the warp
// must take part: the shuffles name the whole warp.
// ---------------------------------------------------------------------------

constexpr unsigned kFullWarp = 0xffffffffu;

// All 12 words of an element whose parts lie over the group, in every lane:
// 12 independent shuffles.
template <int L>
__device__ __forceinline__ void lane_gather(uint32_t* v, const uint32_t* part) {
  constexpr int W = Fp::N / L;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) v[j] = __shfl_sync(kFullWarp, part[j % W], j / W, L);
}

// Lane r's part of a whole element (selects, so that v stays in registers).
template <int L>
__device__ __forceinline__ void lane_part(uint32_t* part, const uint32_t* v, int r) {
  constexpr int W = Fp::N / L;
#pragma unroll
  for (int j = 0; j < W; j++) {
    uint32_t w = v[j];
#pragma unroll
    for (int s = 1; s < L; s++) w = r == s ? v[W * s + j] : w;
    part[j] = w;
  }
}

// t[0..W-1] += c with the carry chain; returns the carry out of t[W-1].
template <int W>
__device__ __forceinline__ uint32_t add_word(uint32_t* t, uint32_t c) {
#pragma unroll
  for (int j = 0; j < W; j++) {
    const uint64_t s = (uint64_t)t[j] + c;
    t[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return c;
}

// Lane r's part of a * b * 2^-384 mod p, in [0, 2p) for a, b < 2p (4p <
// 2^384 keeps CIOS's bound): a_part and m_part are this lane's parts of a
// and of p, b is whole in every lane.  CIOS over the words of b with the
// window t spread over the group: each lane runs the rows a b_i and q p on
// its W words (mad_row<W + 1>, a zero word on top) and keeps, above them,
// a pending carry e of two words that belongs at the next lane's first
// word.  Per word of b two shuffles: q from lane 0's low word, and the
// window's shift, which takes each lane's low word down to the lane below
// (where it meets that lane's e; their sum leaves a new e below 8).  At the
// end each lane adds the e of the lane below, and the one-bit carries that
// this can still ripple are resolved at once by carry lookahead over the
// group's ballots (generate: the add carried out; propagate: the part is
// all ones).  The top lane's e is 0 then, the value being below 2^384.
// No final subtract: the chain keeps its values below 2p and reduces once.
template <int L>
__device__ __forceinline__ void lane_mul(uint32_t* out, const uint32_t* a_part, const uint32_t* b,
                                         const uint32_t* m_part, int r) {
  constexpr int W = Fp::N / L;
  uint32_t t[W + 2], x[W + 1], y[W + 1];
#pragma unroll
  for (int j = 0; j < W; j++) {
    t[j] = 0;
    x[j] = a_part[j];
    y[j] = m_part[j];
  }
  t[W] = t[W + 1] = x[W] = y[W] = 0;
#pragma unroll
  for (int i = 0; i < Fp::N; i++) {
    mad_row<W + 1>(t, x, b[i]);
    const uint32_t q = __shfl_sync(kFullWarp, t[0], 0, L) * Fp::INV;
    mad_row<W + 1>(t, y, q);
    const uint32_t up = __shfl_down_sync(kFullWarp, t[0], 1, L);
#pragma unroll
    for (int j = 0; j + 1 < W; j++) t[j] = t[j + 1];
    const uint64_t s = (uint64_t)(r == L - 1 ? 0u : up) + t[W] + ((uint64_t)t[W + 1] << 32);
    t[W - 1] = (uint32_t)s;
    t[W] = (uint32_t)(s >> 32);
    t[W + 1] = 0;
  }
  const uint32_t below = __shfl_up_sync(kFullWarp, t[W], 1, L);
  const uint32_t g = add_word<W>(t, r == 0 ? 0u : below);
  uint32_t ones = ~0u;
#pragma unroll
  for (int j = 0; j < W; j++) ones &= t[j];
  const unsigned base = (threadIdx.x % 32) & ~(unsigned)(L - 1), mask = (1u << L) - 1;
  const unsigned gen = (__ballot_sync(kFullWarp, g != 0) >> base) & mask;
  const unsigned prop = gen | ((__ballot_sync(kFullWarp, ones == ~0u) >> base) & mask);
  add_word<W>(t, ((gen + prop) ^ gen ^ prop) >> r & 1u);  // bit r: the carry into lane r
#pragma unroll
  for (int j = 0; j < W; j++) out[j] = t[j];
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

// One element of N words (N a multiple of 4) as N / 4 16-byte accesses.
template <int N>
__device__ __forceinline__ void load_vec(uint32_t* r, const uint4* __restrict__ src) {
#pragma unroll
  for (int k = 0; k < N / 4; k++) {
    const uint4 v = __ldg(src + k);
    r[4 * k] = v.x;
    r[4 * k + 1] = v.y;
    r[4 * k + 2] = v.z;
    r[4 * k + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(uint4* __restrict__ dst, const uint32_t* r) {
#pragma unroll
  for (int k = 0; k < N / 4; k++)
    dst[k] = make_uint4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
}

// Host side of the launchers: the widest block (128, 64 or 32 threads) that
// still gives every SM of the current device a block; 32 when even that
// leaves SMs idle.  The SM count is read at each launch (the runtime keeps
// it), so a launch on another card sizes its blocks from that card.
inline int block_threads(long long n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int t = 128; t > 32; t /= 2)
    if ((n + t - 1) / t >= sms) return t;
  return 32;
}

}  // namespace kzg
