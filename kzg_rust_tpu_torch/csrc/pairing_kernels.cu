// The device pairing for Hopper (sm_90a): three kernels over csrc/tower.cuh,
// one thread a lane.
//
// P2 kzg_miller_loop replaces the JAX package's XLA program
// kzg_rust_tpu/ops/pairing.py:202 miller_loop_kernel: the batched
// inversion-free Miller loop, all 63 steps in one launch.  T is homogeneous
// projective over Fp2 with the exception-free RCB doubling and mixed add
// (b3 = 3 * 4 (1 + u) = 12 + 12u on the twist), and each line keeps the
// JAX package's scale, 2 Y Z^2 for a tangent and x2 Z - X for a chord
// (pairing.py:146-176), so f is the JAX program's value word for word,
// not only the final flag.  The bits of |x| are public and the same in
// every lane, so a step branches on its bit where the JAX scan computes
// both outcomes and selects (pairing.py:215-220): the same function.  The
// value is conjugated at the end (x < 0); a lane with an infinity argument
// (active 0) yields one (pairing.py:225).
//
// P3 kzg_final_exp replaces the programs of the final exponentiation:
// _easy_part_kernel (:264), _exp_by_x_with_bits (:236), _mul_conj_kernel
// (:275), _mul_frob_kernel (:280) and _hard_tail_kernel (:294).  Per lane k
// it multiplies the two Miller values f[0, k] f[1, k], runs the easy part,
// the hard part's five exponentiations by x (Granger-Scott squarings, a
// product on each set bit of the bits it is given, MSB first below the
// implicit leading one; the real |x| or a small test exponent) and the
// tail, and writes the is-one flag, or under want_value the value before
// the test, so that a caller can compare values.
//
// P1 kzg_fp12_op replaces no TPU kernel: it runs one Fp12 function of the
// tower over [n] elements (the op codes below), for ops/tower.py's Fp12
// functions on the card, and so that each device function of the tower is
// held against its plain version at width before the loops that compose
// them are: a wrong Miller value can then be traced to its operation.
//
// Bound: operations.  A Miller loop takes ~8.4k Fp products a lane (126 a
// doubling step, 97 more on each of the 5 set bits), a final
// exponentiation ~8.3k (5 x 1,404 in the exponentiations by x, ~470 in the
// Fermat inversion), against ~14.0k and ~23.9k in the JAX forms, which
// compute both outcomes of every bit.  One thread a lane is latency-bound:
// every product of a lane depends on the one before, and a Fp12 element is
// 144 words, so the state lives in local memory (L1) between the
// __noinline__ tower calls.  Spreading each Fp12 product's independent Fp
// products over lanes is later work.

#include "tower.cuh"

namespace kzg {
namespace {

constexpr int kPairThreads = 32;  // threads a block: a block a warp
// |x| for BLS12-381, x = -0xd201000000010000 (golden/field.py BLS_X); the
// Miller loop runs over its bits below the MSB, MSB first.
constexpr unsigned long long kAbsX = 0xd201000000010000ull;
constexpr int kAbsXBits = 64;
// b3 = 12 + 12u in Montgomery form: both coefficients are 12 R mod p.
__constant__ Fe kB3Mont = {{0x0027552eu, 0x44760000u, 0x43480020u, 0xdcb8009au, 0x4a6e8b59u,
                            0x6f7ee9ceu, 0xc0a95bc6u, 0xb10330b7u, 0xfb1e54b7u, 0x6140b1fcu,
                            0x7f0bb4e1u, 0x0381be09u}};

enum Fp12Op { kOpMul = 0, kOpSqr = 1, kOpCycloSqr = 2, kOpFrobenius = 3, kOpInv = 4, kOpMulByLine = 5 };

struct G2 {
  Fe2 x, y, z;
};

__device__ __forceinline__ Fe2 b3() {
  Fe2 r;
  r.c0 = kB3Mont;
  r.c1 = kB3Mont;
  return r;
}

// RCB doubling over Fp2 (the JAX pairing.py _g2_double).
__device__ __noinline__ void g2_double(G2& r, const G2& t) {
  const Fe2 k = b3();
  Fe2 t0, t1, t2, x3, y3, z3, m;
  fe2_sqr(t0, t.y);
  fe2_dbl(z3, t0);
  fe2_dbl(z3, z3);
  fe2_dbl(z3, z3);  // 8 Y^2
  fe2_mul(t1, t.y, t.z);
  fe2_sqr(t2, t.z);
  fe2_mul(t2, k, t2);
  fe2_mul(x3, t2, z3);
  fe2_add(y3, t0, t2);
  fe2_mul(z3, t1, z3);
  fe2_dbl(t1, t2);
  fe2_add(t2, t1, t2);
  fe2_sub(t0, t0, t2);
  fe2_mul(m, t0, y3);
  fe2_add(y3, x3, m);
  fe2_mul(m, t.x, t.y);
  fe2_mul(m, t0, m);
  fe2_dbl(r.x, m);
  r.y = y3;
  r.z = z3;
}

// t projective + (x2, y2) affine, never infinity (RCB mixed add; the JAX
// pairing.py _g2_madd).
__device__ __noinline__ void g2_madd(G2& r, const G2& t, const Fe2& x2, const Fe2& y2) {
  const Fe2 k = b3();
  Fe2 t0, t1, t3, t4, t5, s, u, three_t0, bt2, z3t, t1m, y3t, x3, y3, z3;
  fe2_mul(t0, t.x, x2);
  fe2_mul(t1, t.y, y2);
  fe2_add(s, t.x, t.y);
  fe2_add(u, x2, y2);
  fe2_mul(t3, s, u);
  fe2_add(s, t0, t1);
  fe2_sub(t3, t3, s);
  fe2_mul(t4, y2, t.z);
  fe2_add(t4, t4, t.y);
  fe2_mul(t5, x2, t.z);
  fe2_add(t5, t5, t.x);
  fe2_dbl(three_t0, t0);
  fe2_add(three_t0, three_t0, t0);
  fe2_mul(bt2, k, t.z);
  fe2_add(z3t, t1, bt2);
  fe2_sub(t1m, t1, bt2);
  fe2_mul(y3t, k, t5);
  fe2_mul(s, t3, t1m);
  fe2_mul(u, t4, y3t);
  fe2_sub(x3, s, u);
  fe2_mul(s, y3t, three_t0);
  fe2_mul(u, t1m, z3t);
  fe2_add(y3, s, u);
  fe2_mul(s, z3t, t4);
  fe2_mul(u, three_t0, t3);
  fe2_add(z3, s, u);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// The tangent at t scaled by 2 Y Z^2: c00 = xi 2 Y Z^2 yP, c11 = 3 X^3 -
// 2 Y^2 Z, c12 = -3 X^2 Z xP (the JAX pairing.py tangent_line_coeffs).
__device__ __noinline__ void tangent_line(Fe2* c, const G2& t, const Fe& xp, const Fe& yp) {
  Fe2 xx, yz, three_xx, s, u;
  fe2_sqr(xx, t.x);
  fe2_mul(yz, t.y, t.z);
  fe2_mul(s, yz, t.z);
  fe2_dbl(s, s);
  fe2_dbl(three_xx, xx);
  fe2_add(three_xx, three_xx, xx);
  fe2_mul_xi(s, s);
  fe2_mul_fp(c[0], s, yp);
  fe2_mul(s, three_xx, t.x);
  fe2_sqr(u, t.y);
  fe2_mul(u, u, t.z);
  fe2_dbl(u, u);
  fe2_sub(c[1], s, u);
  fe2_mul(s, three_xx, t.z);
  fe2_mul_fp(s, s, xp);
  fe2_neg(c[2], s);
}

// The chord through t and (x2, y2) scaled by D = x2 Z - X: c00 = xi D yP,
// c11 = N x2 - y2 D, c12 = -N xP with N = y2 Z - Y (the JAX pairing.py
// chord_line_coeffs).
__device__ __noinline__ void chord_line(Fe2* c, const G2& t, const Fe2& x2, const Fe2& y2, const Fe& xp,
                                        const Fe& yp) {
  Fe2 nn, dd, s, u;
  fe2_mul(nn, y2, t.z);
  fe2_sub(nn, nn, t.y);
  fe2_mul(dd, x2, t.z);
  fe2_sub(dd, dd, t.x);
  fe2_mul_xi(s, dd);
  fe2_mul_fp(c[0], s, yp);
  fe2_mul(s, nn, x2);
  fe2_mul(u, y2, dd);
  fe2_sub(c[1], s, u);
  fe2_mul_fp(s, nn, xp);
  fe2_neg(c[2], s);
}

// f_{|x|,Q}(P) conjugated, one lane a thread: n = pairs x checks lanes.
__global__ void __launch_bounds__(kPairThreads)
    miller_kernel(const Fe* __restrict__ xp, const Fe* __restrict__ yp, const Fe2* __restrict__ qx,
                  const Fe2* __restrict__ qy, const uint8_t* __restrict__ active, Fe12* __restrict__ out,
                  uint32_t n) {
  const uint32_t i = blockIdx.x * kPairThreads + threadIdx.x;
  if (i >= n) return;
  Fe12 f = fe12_one();
  if (active[i]) {
    const Fe px = xp[i], py = yp[i];
    const Fe2 x2 = qx[i], y2 = qy[i];
    G2 t;
    t.x = x2;
    t.y = y2;
    t.z = fe2_one();
    Fe2 c[3];
#pragma unroll 1
    for (int b = kAbsXBits - 2; b >= 0; b--) {
      tangent_line(c, t, px, py);
      fe12_sqr(f, f);
      fe12_mul_by_line(f, f, c[0], c[1], c[2]);
      g2_double(t, t);
      if ((kAbsX >> b) & 1ull) {
        chord_line(c, t, x2, y2, px, py);
        fe12_mul_by_line(f, f, c[0], c[1], c[2]);
        g2_madd(t, t, x2, y2);
      }
    }
    fe12_conj(f, f);
  }
  out[i] = f;
}

// The bits of |x| below its MSB, MSB first (or a test exponent's).
struct XBits {
  uint8_t b[kAbsXBits];
  uint32_t count;
};

// m^(-|x|) for cyclotomic m: square-and-multiply over the bits, then the
// conjugate (the cyclotomic inverse).
__device__ __noinline__ void exp_by_x(Fe12& r, const Fe12& m, const XBits& bits) {
  Fe12 acc = m;
#pragma unroll 1
  for (uint32_t k = 0; k < bits.count; k++) {
    fe12_cyclo_sqr(acc, acc);
    if (bits.b[k]) fe12_mul(acc, acc, m);
  }
  fe12_conj(r, acc);
}

// The final exponentiation of f[0, i] f[1, i] (k lanes): the is-one flag,
// or the value under want_value.  Each thread's Fermat table is its column
// of the block's dynamic shared memory.
__global__ void __launch_bounds__(kPairThreads)
    final_exp_kernel(const Fe12* __restrict__ f, void* __restrict__ out, uint32_t k,
                     const __grid_constant__ XBits bits, int want_value) {
  extern __shared__ uint32_t table[];
  const uint32_t i = blockIdx.x * kPairThreads + threadIdx.x;
  if (i >= k) return;
  Fe12 x = f[i], c = f[k + i], m, u, w1, e5;
  // Easy part: m = conj(x) / x, then frob^2(m) m.
  fe12_mul(x, x, c);
  fe12_inv<kPairThreads>(c, x, table + threadIdx.x);
  fe12_conj(x, x);
  fe12_mul(m, x, c);
  fe12_frobenius(c, m);
  fe12_frobenius(c, c);
  fe12_mul(m, c, m);
  // Hard part (the JAX _final_exp_hard_chain): u = m^(x-1), then
  // m^((x-1)^2), w1 = its ^(x+p), e5 = w1^(x^2).
  exp_by_x(c, m, bits);
  fe12_conj(u, m);
  fe12_mul(u, c, u);
  exp_by_x(c, u, bits);
  fe12_conj(x, u);
  fe12_mul(u, c, x);
  exp_by_x(c, u, bits);
  fe12_frobenius(x, u);
  fe12_mul(w1, c, x);
  exp_by_x(c, w1, bits);
  exp_by_x(e5, c, bits);
  // Tail (_hard_tail_expr): e5 frob^2(w1) conj(w1) m^3.
  fe12_frobenius(x, w1);
  fe12_frobenius(x, x);
  fe12_mul(e5, e5, x);
  fe12_conj(x, w1);
  fe12_mul(e5, e5, x);
  fe12_cyclo_sqr(x, m);
  fe12_mul(x, x, m);
  fe12_mul(e5, e5, x);
  if (want_value)
    ((Fe12*)out)[i] = e5;
  else
    ((uint8_t*)out)[i] = fe12_is_one(e5) ? 1 : 0;
}

// One Fp12 function over n elements: a [n] Fp12, b [n] Fp12 (mul) or [n]
// line coefficients (c00, c11, c12) (mul_by_line), out [n] Fp12.
__global__ void __launch_bounds__(kPairThreads)
    tower_op_kernel(const Fe12* __restrict__ a, const void* __restrict__ b, Fe12* __restrict__ out,
                   uint32_t n, int op) {
  extern __shared__ uint32_t table[];
  const uint32_t i = blockIdx.x * kPairThreads + threadIdx.x;
  if (i >= n) return;
  const Fe12 x = a[i];
  Fe12 r;
  switch (op) {
    case kOpMul: {
      const Fe12 y = ((const Fe12*)b)[i];
      fe12_mul(r, x, y);
      break;
    }
    case kOpSqr:
      fe12_sqr(r, x);
      break;
    case kOpCycloSqr:
      fe12_cyclo_sqr(r, x);
      break;
    case kOpFrobenius:
      fe12_frobenius(r, x);
      break;
    case kOpInv:
      fe12_inv<kPairThreads>(r, x, table + threadIdx.x);
      break;
    default: {
      const Fe2* line = (const Fe2*)b + 3 * (size_t)i;
      const Fe2 c00 = line[0], c11 = line[1], c12 = line[2];
      fe12_mul_by_line(r, x, c00, c11, c12);
      break;
    }
  }
  out[i] = r;
}

// Launchers: one block a warp, the Fermat table's shared memory where an
// inversion runs (15 entries x 12 words a thread: 23,040 bytes a block).
constexpr size_t kInvSmem = (size_t)kInvTop * 12 * 4 * kPairThreads;

inline unsigned pair_blocks(long long n) { return (unsigned)((n + kPairThreads - 1) / kPairThreads); }

}  // namespace
}  // namespace kzg

using namespace kzg;

extern "C" int kzg_fp12_op(const void* a, const void* b, void* out, long long n, int op, void* stream) {
  if (op < kOpMul || op > kOpMulByLine || n < 1 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  tower_op_kernel<<<pair_blocks(n), kPairThreads, op == kOpInv ? kInvSmem : 0, (cudaStream_t)stream>>>(
      (const Fe12*)a, b, (Fe12*)out, (uint32_t)n, op);
  return (int)cudaGetLastError();
}

extern "C" int kzg_miller_loop(const void* xp, const void* yp, const void* qx, const void* qy,
                               const void* active, void* out, long long n, void* stream) {
  if (n < 1 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  miller_kernel<<<pair_blocks(n), kPairThreads, 0, (cudaStream_t)stream>>>(
      (const Fe*)xp, (const Fe*)yp, (const Fe2*)qx, (const Fe2*)qy, (const uint8_t*)active, (Fe12*)out,
      (uint32_t)n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_final_exp(const void* f, void* out, long long k, const void* bits, long long nbits,
                             int want_value, void* stream) {
  if (k < 1 || k >= (1ll << 31) || nbits < 0 || nbits > kAbsXBits) return (int)cudaErrorInvalidValue;
  XBits xb{};
  xb.count = (uint32_t)nbits;
  for (long long j = 0; j < nbits; j++) {
    xb.b[j] = ((const uint8_t*)bits)[j];
    if (xb.b[j] > 1) return (int)cudaErrorInvalidValue;
  }
  final_exp_kernel<<<pair_blocks(k), kPairThreads, kInvSmem, (cudaStream_t)stream>>>(
      (const Fe12*)f, out, (uint32_t)k, xb, want_value);
  return (int)cudaGetLastError();
}
