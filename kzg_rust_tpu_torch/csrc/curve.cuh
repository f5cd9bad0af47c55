// G1 point arithmetic for Hopper (sm_90a): the Fp element type of the curve
// kernels and the complete formulas of Renes, Costello and Batina (eprint
// 2015/1060, a = 0, b3 = 3 b = 12) that more than one kernel file uses.
// Shared by curve_kernels.cu (K3, K4) and msm_kernels.cu (M2 and the mixed
// add launcher).  Every value is a canonical Fp element in Montgomery form.

#pragma once

#include "field.cuh"

namespace kzg {

struct Elt {
  uint32_t w[Fp::N];
};

__device__ __forceinline__ Elt mul(const Elt& a, const Elt& b) {
  Elt r;
  fp_mont_mul(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Elt add(const Elt& a, const Elt& b) {
  Elt r;
  fp_add(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Elt sub(const Elt& a, const Elt& b) {
  Elt r;
  fp_sub(r.w, a.w, b.w);
  return r;
}

// b3 v = 12 v by four adds: the canonical value of the product by mont(12)
// that curve.py takes, at a tenth of its instructions.
__device__ __forceinline__ Elt times_b3(const Elt& v) {
  const Elt v2 = add(v, v);
  const Elt v4 = add(v2, v2);
  return add(add(v4, v4), v4);
}

// One coordinate (three 16-byte vectors) from device memory.
__device__ __forceinline__ Elt ldg(const uint4* __restrict__ g) {
  Elt r;
#pragma unroll
  for (int k = 0; k < 3; k++) {
    const uint4 v = __ldg(g + k);
    r.w[4 * k] = v.x;
    r.w[4 * k + 1] = v.y;
    r.w[4 * k + 2] = v.z;
    r.w[4 * k + 3] = v.w;
  }
  return r;
}

__device__ __forceinline__ void stg(uint4* __restrict__ g, const Elt& e) {
#pragma unroll
  for (int k = 0; k < 3; k++) g[k] = make_uint4(e.w[4 * k], e.w[4 * k + 1], e.w[4 * k + 2], e.w[4 * k + 3]);
}

// (X, Y, Z) += (x2, y2): the complete mixed add, RCB algorithm 8 (a = 0), in
// the order of the JAX package's curve.py proj_add_mixed (:157), so every
// output is the same canonical integer.  11 products; the two products by b3
// are adds.  (x2, y2) is affine (Z2 = 1) and must not be the point at
// infinity; (X, Y, Z) may be.  Each temporary dies at its last use, so at
// most six 12-word values are live beside a product.
__device__ __forceinline__ void add_mixed(Elt& X, Elt& Y, Elt& Z, const Elt& x2, const Elt& y2) {
  const Elt t0 = mul(X, x2);
  const Elt t1 = mul(Y, y2);
  const Elt t3 = sub(mul(add(X, Y), add(x2, y2)), add(t0, t1));  // X1 Y2 + X2 Y1
  const Elt t4 = add(mul(y2, Z), Y);                              // Y1 + Y2 Z1
  const Elt t5 = add(mul(x2, Z), X);                              // X1 + X2 Z1
  const Elt three_t0 = add(add(t0, t0), t0);
  const Elt bt2 = times_b3(Z);
  const Elt z3t = add(t1, bt2);
  const Elt t1m = sub(t1, bt2);
  const Elt y3t = times_b3(t5);
  X = sub(mul(t3, t1m), mul(t4, y3t));
  Y = add(mul(y3t, three_t0), mul(t1m, z3t));
  Z = add(mul(z3t, t4), mul(three_t0, t3));
}

}  // namespace kzg
