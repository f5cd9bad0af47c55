// G1 point arithmetic for Hopper (sm_90a): the Fp element type of the curve
// kernels and the complete formulas of Renes, Costello and Batina (eprint
// 2015/1060, a = 0, b3 = 3 b = 12) that more than one kernel file uses.
// Shared by curve_kernels.cu (K3, K4) and msm_kernels.cu (M2 with its
// reduction, and the mixed add launcher).  Every value is a canonical Fp
// element in Montgomery form.

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

// One coordinate from shared memory.  asm volatile keeps each reload where
// the formula needs it, so the compiler cannot hold the operand in
// registers across the products instead.
__device__ __forceinline__ Elt lds(const uint4* s) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(s);
  Elt r;
#pragma unroll
  for (int k = 0; k < 3; k++)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.w[4 * k]), "=r"(r.w[4 * k + 1]), "=r"(r.w[4 * k + 2]),
                   "=r"(r.w[4 * k + 3])
                 : "r"(a + 16 * k));
  return r;
}

__device__ __forceinline__ void sts(uint4* s, const Elt& v) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(s);
#pragma unroll
  for (int k = 0; k < 3; k++)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a + 16 * k),
                 "r"(v.w[4 * k]), "r"(v.w[4 * k + 1]), "r"(v.w[4 * k + 2]),
                 "r"(v.w[4 * k + 3])
                 : "memory");
}

// a += b for two projective points in shared memory (9 16-byte vectors
// each: X at 0-2, Y at 3-5, Z at 6-8) by one thread: the complete add, RCB
// algorithm 7 (a = 0), in the order of curve.py's proj_add (:122).  The
// products of X come first, then those of Y and Z; a coordinate's slots
// take temporaries once its last product is done (b's slots too: b is
// spent), so at most four 12-word temporaries are live in registers beside
// the product being taken.  X3 waits in b's Z slot until t3 leaves a's X
// slot.  K3's thread body; M2's trees take the same add over lanes
// (add_lanes below).
__device__ __forceinline__ void add_staged(uint4* a, uint4* b) {
  uint4 *const ax = a, *const ay = a + 3, *const az = a + 6;
  uint4 *const bx = b, *const by = b + 3, *const bz = b + 6;
  const Elt t0 = mul(lds(ax), lds(bx));
  const Elt r3 = mul(add(lds(ax), lds(ay)), add(lds(bx), lds(by)));  // t3 + t0 + t1
  const Elt r5 = mul(add(lds(ax), lds(az)), add(lds(bx), lds(bz)));  // t5 + t0 + t2
  sts(ax, r3);
  sts(bx, r5);
  const Elt t1 = mul(lds(ay), lds(by));
  const Elt t2 = mul(lds(az), lds(bz));
  sts(by, sub(mul(add(lds(ay), lds(az)), add(lds(by), lds(bz))), add(t1, t2)));  // t4
  sts(ax, sub(lds(ax), add(t0, t1)));                                             // t3
  const Elt t5 = sub(lds(bx), add(t0, t2));
  sts(bx, add(add(t0, t0), t0));                                                  // 3 t0
  const Elt bt2 = times_b3(t2);
  const Elt z3t = add(t1, bt2);
  const Elt t1m = sub(t1, bt2);
  const Elt y3t = times_b3(t5);
  sts(bz, mul(lds(ax), t1m));
  sts(bz, sub(lds(bz), mul(lds(by), y3t)));                        // X3
  sts(ay, add(mul(y3t, lds(bx)), mul(t1m, z3t)));                 // Y3
  sts(az, add(mul(z3t, lds(by)), mul(lds(bx), lds(ax))));         // Z3
  sts(ax, lds(bz));
}

__device__ __forceinline__ Elt sel(bool c, const Elt& a, const Elt& b) {
  Elt r;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// out = a + b as add_staged, by the G lanes of one group (G = 2, 4 or 8;
// lane r in 0..G-1, mask naming the group's lanes).  The formula's
// twelve products fall into two levels of six independent ones, and lane r
// takes products r, r + G, ... of each level, so a point waits for 12 / G
// products, or two with G = 8 (lanes 6 and 7 then idle), not twelve.  The
// lanes exchange the first level's products through the group's scratch s;
// the second level multiplies pairs of six operands (t3, t4, b3 t5,
// t1 - b3 t2, t1 + b3 t2, 3 t0) formed from them, which the lanes exchange
// too (s: twelve coordinates).  With G < 6 each lane forms all six and
// stores its own; with G = 8 lane q forms operand q alone, as
// k (x - y - z) + w over the products with k in {1, 3, 12}: 7 field adds
// on a lane's path instead of 17.  Lanes 0-2 form X3 = q0 - q1, Y3 = q2 + q3 and Z3 = q4 + q5 from
// the second level's products into out.  Every coordinate is the canonical
// value of the same field element, so out gets add_staged's words.  The
// operands come from coord_a(c) and coord_b(c) (coordinate c, read in the
// first level only), so they may lie in shared or device memory; out may
// be a.
template <int G, class CoordA, class CoordB>
__device__ __forceinline__ void add_lanes_from(uint4* out, const CoordA& coord_a, const CoordB& coord_b, uint4* s,
                                               int r, unsigned mask) {
  Elt zero;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) zero.w[j] = 0;
  // t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, r3 = (X1 + Y1)(X2 + Y2),
  // r4 = (Y1 + Z1)(Y2 + Z2), r5 = (X1 + Z1)(X2 + Z2): coordinate u, plus
  // coordinate v from q = 3 on.
  for (int q = r; q < 6; q += G) {
    const int u = q < 3 ? q : (q == 4 ? 1 : 0), v = q == 3 ? 1 : 2;
    const Elt x = add(coord_a(u), sel(q >= 3, coord_a(v), zero));
    const Elt y = add(coord_b(u), sel(q >= 3, coord_b(v), zero));
    sts(s + 3 * q, mul(x, y));
  }
  __syncwarp(mask);
  // The second level: the six operands (t3, t4, y3t, t1m, z3t, 3t0) go to
  // s + 18 (coordinates 6-11), and product q multiplies operand q by
  // operand (3, 2, 5, 4, 1, 0)[q]: q0 = t3 t1m, q1 = t4 y3t, q2 = y3t 3t0,
  // q3 = t1m z3t, q4 = z3t t4, q5 = 3t0 t3.
  if constexpr (G >= 6) {
    // Operand q = k (x - y - z) + w, x, y, z, w products or 0: t3 = r3 -
    // t0 - t1, t4 = r4 - t1 - t2, y3t = 12 (r5 - t0 - t2), t1m = 12 (0 -
    // t2) + t1, z3t = 12 t2 + t1, 3t0 = 3 t0.
    if (r < 6) {
      const int xi = r == 0 ? 3 : r == 1 ? 4 : r == 2 ? 5 : r == 4 ? 2 : r == 5 ? 0 : -1;
      const int yi = r == 0 ? 0 : r == 1 ? 1 : r == 2 ? 0 : r == 3 ? 2 : -1;
      const int zi = r == 0 ? 1 : r == 1 || r == 2 ? 2 : -1;
      const Elt x = xi < 0 ? zero : lds(s + 3 * xi);
      const Elt y = yi < 0 ? zero : lds(s + 3 * yi);
      const Elt z = zi < 0 ? zero : lds(s + 3 * zi);
      const Elt d = sub(sub(x, y), z);
      const Elt d3 = add(add(d, d), d);
      const Elt d6 = add(d3, d3);
      const Elt k = r < 2 ? d : r == 5 ? d3 : add(d6, d6);
      sts(s + 18 + 3 * r, r == 3 || r == 4 ? add(k, lds(s + 3)) : k);
    }
  } else {
    const Elt t0 = lds(s), t1 = lds(s + 3), t2 = lds(s + 6);
    const Elt bt2 = times_b3(t2);
    const Elt ops[6] = {sub(lds(s + 9), add(t0, t1)), sub(lds(s + 12), add(t1, t2)),
                        times_b3(sub(lds(s + 15), add(t0, t2))), sub(t1, bt2), add(t1, bt2), add(add(t0, t0), t0)};
#pragma unroll
    for (int q = 0; q < 6; q++)
      if (q % G == r) sts(s + 18 + 3 * q, ops[q]);
  }
  __syncwarp(mask);
  for (int q = r; q < 6; q += G) {
    const int pair = q == 0 ? 3 : q == 1 ? 2 : q == 2 ? 5 : q == 3 ? 4 : q == 4 ? 1 : 0;
    sts(s + 3 * q, mul(lds(s + 18 + 3 * q), lds(s + 18 + 3 * pair)));
  }
  __syncwarp(mask);
  for (int c = r; c < 3; c += G) {
    const Elt e = lds(s + 6 * c), f = lds(s + 6 * c + 3);
    sts(out + 3 * c, c == 0 ? sub(e, f) : add(e, f));
  }
  __syncwarp(mask);
}

// a += b by the G lanes of one group, both points in shared memory (9
// 16-byte vectors each: X at 0-2, Y at 3-5, Z at 6-8); b is only read.
template <int G>
__device__ __forceinline__ void add_lanes(uint4* a, const uint4* b, uint4* s, int r, unsigned mask) {
  add_lanes_from<G>(a, [a](int c) { return lds(a + 3 * c); }, [b](int c) { return lds(b + 3 * c); }, s, r, mask);
}

}  // namespace kzg
