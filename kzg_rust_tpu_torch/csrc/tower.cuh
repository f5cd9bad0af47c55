// The extension tower Fp2 -> Fp6 -> Fp12 for Hopper (sm_90a): the device
// functions of the pairing kernels (pairing_kernels.cu), one thread an
// element, on csrc/field.cuh's Fp product, squaring, add and sub.
//
// The formulas are the JAX package's kzg_rust_tpu/ops/tower.py (and through
// it golden/field.py:137-393):
//
//     Fp2  = c0 + c1 u        u^2 = -1
//     Fp6  = c0 + c1 v + c2 v^2        v^3 = xi = 1 + u
//     Fp12 = c0 + c1 w        w^2 = v
//
// An element is its Fp coefficients in the JAX nesting order, so an Fe12 is
// the 144 words of the port's [..., 2, 3, 2, 12] tensors (ops/tower.py).
// Every value is canonical Montgomery (R = 2^384), so a function gives the
// same words as the plain PyTorch version of the same field operations.
// Fp12's Granger-Scott squaring (fe12_cyclo_sqr) is the JAX formula itself:
// it squares only cyclotomic elements, and on any other input it gives the
// formula's words, as the JAX function does.
//
// Build time: the Fp product is inline asm (field.cuh), so only the Fp2
// product, squaring and Fp scaling inline it; every Fp6 and Fp12 function
// and the inversions are __noinline__ calls on elements in local memory,
// which keeps the pairing's 63-step loops (#pragma unroll 1) a few
// thousand instructions long.  Every function here may take its output as
// one of its inputs: each writes its result after its last read.

#pragma once

#include "field.cuh"

namespace kzg {

struct Fe {
  uint32_t w[12];
};
struct Fe2 {
  Fe c0, c1;
};
struct Fe6 {
  Fe2 c[3];
};
struct Fe12 {
  Fe6 c[2];
};

// Montgomery constants (checked against golden/field.py by the CPU tests,
// which parse this file): 1, and the Frobenius coefficients gamma^k =
// xi^(k (p - 1) / 6), k = 0 .. 5 (golden/field.py:412, the JAX
// tower.py:277), each c0 then c1.
__constant__ Fe kOneMont = {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
                             0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
                             0xfa80e493u, 0x15f65ec3u}};
__constant__ Fe2 kGamma[6] = {
    {{{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
       0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u}},
     {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
       0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}},
    {{{0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu,
       0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu}},
     {{0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u,
       0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau}}},
    {{{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
       0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
       0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u}}},
    {{{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
       0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}},
     {{0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u,
       0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu}}},
    {{{0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u,
       0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu}},
     {{0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
       0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}},
    {{{0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u,
       0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu}},
     {{0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu,
       0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu}}},
};

// The Fermat inversion's exponent p - 2 as the 4-bit digits of the chain
// code that K1's kzg_fp_pow_const runs (field.cuh pow_const), most
// significant first; its largest digit is 15.
__constant__ PowDigits kInvDigits = {
    {1,  10, 0,  1,  1,  1,  14, 10, 3,  9,  7,  15, 14, 6,  9,  10, 4,  11, 1,  11,
     10, 7,  11, 6,  4,  3,  4,  11, 10, 12, 13, 7,  6,  4,  7,  7,  4,  11, 8,  4,
     15, 3,  8,  5,  1,  2,  11, 15, 6,  7,  3,  0,  13, 2,  10, 0,  15, 6,  11, 0,
     15, 6,  2,  4,  1,  14, 10, 11, 15, 15, 15, 14, 11, 1,  5,  3,  15, 15, 15, 15,
     11, 9,  15, 14, 15, 15, 15, 15, 15, 15, 15, 15, 10, 10, 10, 9},
    96,
    15};
constexpr int kInvTop = 15;

// ---------------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b) {
  Fe t;
  fp_add(t.w, a.w, b.w);
  r = t;
}

__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  Fe t;
  fp_sub(t.w, a.w, b.w);
  r = t;
}

__device__ __forceinline__ void fe_neg(Fe& r, const Fe& a) {
  const Fe zero = {};
  fe_sub(r, zero, a);
}

__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b) { fp_mont_mul(r.w, a.w, b.w); }

__device__ __forceinline__ void fe_sqr(Fe& r, const Fe& a) { fp_mont_sqr(r.w, a.w); }

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < 12; j++) d |= a.w[j] ^ b.w[j];
  return d == 0;
}

// ---------------------------------------------------------------------------
// Fp2
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe2 fe2_one() {
  Fe2 r = {};
  r.c0 = kOneMont;
  return r;
}

__device__ __forceinline__ void fe2_add(Fe2& r, const Fe2& a, const Fe2& b) {
  fe_add(r.c0, a.c0, b.c0);
  fe_add(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fe2_sub(Fe2& r, const Fe2& a, const Fe2& b) {
  fe_sub(r.c0, a.c0, b.c0);
  fe_sub(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fe2_neg(Fe2& r, const Fe2& a) {
  fe_neg(r.c0, a.c0);
  fe_neg(r.c1, a.c1);
}

__device__ __forceinline__ void fe2_dbl(Fe2& r, const Fe2& a) { fe2_add(r, a, a); }

__device__ __forceinline__ void fe2_conj(Fe2& r, const Fe2& a) {
  r.c0 = a.c0;
  fe_neg(r.c1, a.c1);
}

// Multiply by xi = 1 + u: (c0 - c1, c0 + c1).
__device__ __forceinline__ void fe2_mul_xi(Fe2& r, const Fe2& a) {
  Fe t0, t1;
  fe_sub(t0, a.c0, a.c1);
  fe_add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

// Karatsuba over u^2 = -1: 3 Fp products.
__device__ __noinline__ void fe2_mul(Fe2& r, const Fe2& a, const Fe2& b) {
  Fe s, t, t0, t1, m;
  fe_add(s, a.c0, a.c1);
  fe_add(t, b.c0, b.c1);
  fe_mul(t0, a.c0, b.c0);
  fe_mul(t1, a.c1, b.c1);
  fe_mul(m, s, t);
  fe_sub(m, m, t0);
  fe_sub(r.c0, t0, t1);
  fe_sub(r.c1, m, t1);
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 Fp products.
__device__ __noinline__ void fe2_sqr(Fe2& r, const Fe2& a) {
  Fe s, d, a2, c0, c1;
  fe_add(s, a.c0, a.c1);
  fe_sub(d, a.c0, a.c1);
  fe_add(a2, a.c0, a.c0);
  fe_mul(c0, s, d);
  fe_mul(c1, a2, a.c1);
  r.c0 = c0;
  r.c1 = c1;
}

__device__ __noinline__ void fe2_mul_fp(Fe2& r, const Fe2& a, const Fe& k) {
  Fe c0, c1;
  fe_mul(c0, a.c0, k);
  fe_mul(c1, a.c1, k);
  r.c0 = c0;
  r.c1 = c1;
}

// (a0 - a1 u) / (a0^2 + a1^2), the norm inverted by Fermat with K1's chain
// (field.cuh pow_const over this thread's column of the block's shared
// table, T threads a block).  inv(0) = 0.
template <int T>
__device__ __noinline__ void fe2_inv(Fe2& r, const Fe2& a, uint32_t* col) {
  Fe n0, n1, ninv, c0, c1;
  fe_sqr(n0, a.c0);
  fe_sqr(n1, a.c1);
  fe_add(n0, n0, n1);
  pow_const<Fp, T>(ninv.w, n0.w, col, kInvDigits);
  fe_mul(c0, a.c0, ninv);
  fe_mul(c1, a.c1, ninv);
  fe_neg(r.c1, c1);
  r.c0 = c0;
}

// ---------------------------------------------------------------------------
// Fp6
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fe6_add(Fe6& r, const Fe6& a, const Fe6& b) {
#pragma unroll
  for (int k = 0; k < 3; k++) fe2_add(r.c[k], a.c[k], b.c[k]);
}

__device__ __forceinline__ void fe6_sub(Fe6& r, const Fe6& a, const Fe6& b) {
#pragma unroll
  for (int k = 0; k < 3; k++) fe2_sub(r.c[k], a.c[k], b.c[k]);
}

__device__ __forceinline__ void fe6_neg(Fe6& r, const Fe6& a) {
#pragma unroll
  for (int k = 0; k < 3; k++) fe2_neg(r.c[k], a.c[k]);
}

__device__ __forceinline__ void fe6_mul_by_v(Fe6& r, const Fe6& a) {
  Fe2 t;
  fe2_mul_xi(t, a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// Karatsuba-Toom over v^3 = xi: 6 Fp2 products (golden/field.py:275-287).
__device__ __noinline__ void fe6_mul(Fe6& r, const Fe6& a, const Fe6& b) {
  Fe2 t0, t1, t2, s, u, m, c0, c1;
  fe2_mul(t0, a.c[0], b.c[0]);
  fe2_mul(t1, a.c[1], b.c[1]);
  fe2_mul(t2, a.c[2], b.c[2]);
  // c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
  fe2_add(s, a.c[1], a.c[2]);
  fe2_add(u, b.c[1], b.c[2]);
  fe2_mul(m, s, u);
  fe2_sub(m, m, t1);
  fe2_sub(m, m, t2);
  fe2_mul_xi(m, m);
  fe2_add(c0, t0, m);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  fe2_add(s, a.c[0], a.c[1]);
  fe2_add(u, b.c[0], b.c[1]);
  fe2_mul(m, s, u);
  fe2_sub(m, m, t0);
  fe2_sub(m, m, t1);
  fe2_mul_xi(u, t2);
  fe2_add(c1, m, u);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  fe2_add(s, a.c[0], a.c[2]);
  fe2_add(u, b.c[0], b.c[2]);
  fe2_mul(m, s, u);
  fe2_sub(m, m, t0);
  fe2_sub(m, m, t2);
  fe2_add(r.c[2], m, t1);
  r.c[0] = c0;
  r.c[1] = c1;
}

__device__ __noinline__ void fe6_mul_fp2(Fe6& r, const Fe6& a, const Fe2& k) {
#pragma unroll 1
  for (int j = 0; j < 3; j++) fe2_mul(r.c[j], a.c[j], k);
}

// golden/field.py:303-313.
template <int T>
__device__ __noinline__ void fe6_inv(Fe6& r, const Fe6& a, uint32_t* col) {
  Fe2 t0, t1, t2, x, y;
  fe2_sqr(t0, a.c[0]);
  fe2_mul(x, a.c[1], a.c[2]);
  fe2_mul_xi(x, x);
  fe2_sub(t0, t0, x);  // a0^2 - xi a1 a2
  fe2_sqr(t1, a.c[2]);
  fe2_mul_xi(t1, t1);
  fe2_mul(x, a.c[0], a.c[1]);
  fe2_sub(t1, t1, x);  // xi a2^2 - a0 a1
  fe2_sqr(t2, a.c[1]);
  fe2_mul(x, a.c[0], a.c[2]);
  fe2_sub(t2, t2, x);  // a1^2 - a0 a2
  fe2_mul(x, a.c[2], t1);
  fe2_mul(y, a.c[1], t2);
  fe2_add(x, x, y);
  fe2_mul_xi(x, x);
  fe2_mul(y, a.c[0], t0);
  fe2_add(x, y, x);  // a0 t0 + xi (a2 t1 + a1 t2)
  fe2_inv<T>(x, x, col);
  fe2_mul(r.c[0], t0, x);
  fe2_mul(r.c[1], t1, x);
  fe2_mul(r.c[2], t2, x);
}

// ---------------------------------------------------------------------------
// Fp12
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe12 fe12_one() {
  Fe12 r = {};
  r.c[0].c[0].c0 = kOneMont;
  return r;
}

__device__ __forceinline__ bool fe12_is_one(const Fe12& a) {
  const Fe12 one = fe12_one();
  bool eq = true;
#pragma unroll
  for (int h = 0; h < 2; h++)
#pragma unroll
    for (int k = 0; k < 3; k++)
      eq = eq && fe_eq(a.c[h].c[k].c0, one.c[h].c[k].c0) && fe_eq(a.c[h].c[k].c1, one.c[h].c[k].c1);
  return eq;
}

__device__ __forceinline__ void fe12_conj(Fe12& r, const Fe12& a) {
  r.c[0] = a.c[0];
  fe6_neg(r.c[1], a.c[1]);
}

// 3 Fp6 products.
__device__ __noinline__ void fe12_mul(Fe12& r, const Fe12& a, const Fe12& b) {
  Fe6 t0, t1, s, u;
  fe6_mul(t0, a.c[0], b.c[0]);
  fe6_mul(t1, a.c[1], b.c[1]);
  fe6_add(s, a.c[0], a.c[1]);
  fe6_add(u, b.c[0], b.c[1]);
  fe6_mul(s, s, u);
  fe6_sub(s, s, t0);
  fe6_sub(r.c[1], s, t1);
  fe6_mul_by_v(t1, t1);
  fe6_add(r.c[0], t0, t1);
}

// Complex squaring, 2 Fp6 products: c0 = (a0 + a1)(a0 + v a1) - t - v t,
// c1 = 2 t with t = a0 a1.
__device__ __noinline__ void fe12_sqr(Fe12& r, const Fe12& a) {
  Fe6 t, s, u;
  fe6_mul(t, a.c[0], a.c[1]);
  fe6_add(s, a.c[0], a.c[1]);
  fe6_mul_by_v(u, a.c[1]);
  fe6_add(u, a.c[0], u);
  fe6_mul(s, s, u);
  fe6_sub(s, s, t);
  fe6_mul_by_v(u, t);
  fe6_sub(r.c[0], s, u);
  fe6_add(r.c[1], t, t);
}

template <int T>
__device__ __noinline__ void fe12_inv(Fe12& r, const Fe12& a, uint32_t* col) {
  Fe6 n0, n1;
  fe6_mul(n0, a.c[0], a.c[0]);
  fe6_mul(n1, a.c[1], a.c[1]);
  fe6_mul_by_v(n1, n1);
  fe6_sub(n0, n0, n1);
  fe6_inv<T>(n0, n0, col);
  fe6_mul(n1, a.c[1], n0);
  fe6_mul(r.c[0], a.c[0], n0);
  fe6_neg(r.c[1], n1);
}

// z = 2 (t - g) + t, or 2 (t + g) + t with plus: a term of fe12_cyclo_sqr.
__device__ __forceinline__ void cyclo_term(Fe2& z, const Fe2& t, const Fe2& g, bool plus) {
  Fe2 s;
  if (plus)
    fe2_add(s, t, g);
  else
    fe2_sub(s, t, g);
  fe2_dbl(s, s);
  fe2_add(z, s, t);
}

// Granger-Scott squaring, 9 Fp2 squarings (golden/field.py fp12_cyclo_sqr).
__device__ __noinline__ void fe12_cyclo_sqr(Fe12& r, const Fe12& a) {
  const Fe2 &g0 = a.c[0].c[0], &g1 = a.c[0].c[1], &g2 = a.c[0].c[2];
  const Fe2 &g3 = a.c[1].c[0], &g4 = a.c[1].c[1], &g5 = a.c[1].c[2];
  Fe2 t0, t1, t2, t3, t4, t5, t6, t7, t8, s;
  fe2_sqr(t0, g4);
  fe2_sqr(t1, g0);
  fe2_add(s, g4, g0);
  fe2_sqr(t6, s);
  fe2_sub(t6, t6, t0);
  fe2_sub(t6, t6, t1);  // 2 g0 g4
  fe2_sqr(t2, g2);
  fe2_sqr(t3, g3);
  fe2_add(s, g2, g3);
  fe2_sqr(t7, s);
  fe2_sub(t7, t7, t2);
  fe2_sub(t7, t7, t3);  // 2 g2 g3
  fe2_sqr(t4, g5);
  fe2_sqr(t5, g1);
  fe2_add(s, g5, g1);
  fe2_sqr(t8, s);
  fe2_sub(t8, t8, t4);
  fe2_sub(t8, t8, t5);
  fe2_mul_xi(t8, t8);  // 2 g1 g5 xi
  fe2_mul_xi(t0, t0);
  fe2_add(t0, t0, t1);  // g0^2 + xi g4^2
  fe2_mul_xi(t2, t2);
  fe2_add(t2, t2, t3);  // g3^2 + xi g2^2
  fe2_mul_xi(t4, t4);
  fe2_add(t4, t4, t5);  // g1^2 + xi g5^2
  Fe12 z;
  cyclo_term(z.c[0].c[0], t0, g0, false);
  cyclo_term(z.c[0].c[1], t2, g1, false);
  cyclo_term(z.c[0].c[2], t4, g2, false);
  cyclo_term(z.c[1].c[0], t8, g3, true);
  cyclo_term(z.c[1].c[1], t6, g4, true);
  cyclo_term(z.c[1].c[2], t7, g5, true);
  r = z;
}

// The p-power Frobenius: coefficient k of w^k (a.c[k % 2].c[k / 2])
// conjugated and multiplied by gamma^k.
__device__ __noinline__ void fe12_frobenius(Fe12& r, const Fe12& a) {
  Fe12 z;
#pragma unroll 1
  for (int h = 0; h < 2; h++) {
#pragma unroll 1
    for (int k = 0; k < 3; k++) {
      const int e = 2 * k + h;
      Fe2 x;
      fe2_conj(x, a.c[h].c[k]);
      if (e) {
        const Fe2 g = kGamma[e];
        fe2_mul(x, x, g);
      }
      z.c[h].c[k] = x;
    }
  }
  r = z;
}

// (x0 + x1 v + x2 v^2)(y1 v + y2 v^2): 5 Fp2 products.
__device__ __noinline__ void fe6_mul_sparse01(Fe6& r, const Fe6& a, const Fe2& y1, const Fe2& y2) {
  Fe2 m11, m22, s, u, c0, c1;
  fe2_mul(m11, a.c[1], y1);
  fe2_mul(m22, a.c[2], y2);
  fe2_add(s, a.c[1], a.c[2]);
  fe2_add(u, y1, y2);
  fe2_mul(s, s, u);
  fe2_add(u, m11, m22);
  fe2_sub(s, s, u);
  fe2_mul_xi(c0, s);
  fe2_mul(s, a.c[0], y1);
  fe2_mul_xi(u, m22);
  fe2_add(c1, s, u);
  fe2_mul(s, a.c[0], y2);
  fe2_add(r.c[2], s, m11);
  r.c[0] = c0;
  r.c[1] = c1;
}

// f ((c00, 0, 0) + (0, c11, c12) w), the sparse shape of every line
// (the JAX pairing.py fp12_mul_by_line): 14 Fp2 products against 18.
__device__ __noinline__ void fe12_mul_by_line(Fe12& r, const Fe12& f, const Fe2& c00, const Fe2& c11,
                                              const Fe2& c12) {
  Fe6 t0, t1, s, b;
  fe6_mul_fp2(t0, f.c[0], c00);
  fe6_mul_sparse01(t1, f.c[1], c11, c12);
  fe6_add(s, f.c[0], f.c[1]);
  b.c[0] = c00;
  b.c[1] = c11;
  b.c[2] = c12;
  fe6_mul(s, s, b);
  fe6_sub(s, s, t0);
  fe6_sub(r.c[1], s, t1);
  fe6_mul_by_v(t1, t1);
  fe6_add(r.c[0], t0, t1);
}

}  // namespace kzg
