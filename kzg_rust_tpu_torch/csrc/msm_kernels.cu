// The fixed-base GLV MSM of the prover for Hopper (sm_90a): the scalar
// recoding (M1) and the whole MSM after it, the digit-selected mixed-add
// accumulation over the affine window table and its reduction to one point
// (M2), plus the mixed add alone as a launcher.
//
// M1, kzg_glv_digits, replaces the XLA program of the JAX package's
// kzg_rust_tpu/ops/msm.py:187 glv_digits_from_limbs (with glv_decompose_limbs
// :133 and _digits_base32 :165).  M2, kzg_msm_glv, replaces the gather of
// :202 _msm_core_glv and the masked mixed-add scan and fold of
// kzg_rust_tpu/ops/curve.py:350 fold_reduce_mixed.  The JAX package never
// wrote either in Pallas; the TPU ran them as XLA programs.
//
// M1.  The device GLV split of glv.py for each scalar k (canonical Fr, 8
// words): m1 = floor(k G1C / 2^264) (a 8 x 5-word product, shifted by 8
// words and 8 bits), m2' = [k >= (r + 1) / 2], k1 = k - (m1 z^2 + m2') and
// k2 = m2' (z^2 - 1) - m1, both below 2^128 in magnitude, then the signed
// base-32 recoding of each magnitude (26 digits in [-16, 16], a digit above
// 16 borrows from the next window) with the sign folded in.  The same
// integers as the JAX program, so the same digits.  Bound: bytes (32 in,
// 52 out a scalar); the work is a few hundred multiply-adds a scalar.
// What bounds it on this card is the launch and one scalar's chain: the
// first design, one thread a scalar in blocks of 128 (32 blocks for a blob's
// 4096 scalars, so 100 SMs idle), ran the product, the split and 52
// dependent digit steps with their carries.  The lane design
// (glv_digits_lanes_kernel, below) spreads a scalar over 8 lanes in blocks
// of 32 scalars (128 SMs at work): the product by columns with its carries
// by ballot lookahead, the two halves recoded on different lanes with the
// windows' carries by ballot lookahead, and the digits through shared
// memory so that a warp's stores are whole sectors.  The one-thread design
// stays as the variant of 1 lane.
//
// M2.  A accumulators ("accs"), one a thread, in blocks of T threads.
// Accumulator a takes the selections s = a, a + A, a + 2A, ... of the 52 N,
// s = (half * 26 + window) * N + point, the layout of the digits [2, 26, N].
// For each selection with a nonzero digit d and a base that is not infinity
// it loads the affine entry table[window, |d| - 1, point] directly (the JAX
// package's one-hot masked reduction over the 16 multiples answered XLA's
// slow gather on the TPU and is not carried over), negates Y for d < 0,
// multiplies X by beta for the phi half (the GLV endomorphism phi(x, y) =
// (beta x, y) commutes with the multiples), and mixed-adds it onto its
// accumulator; the accumulator's first selection is taken as it is,
// (x, y, 1), which saves a quarter of the adds at mainnet width, and one
// that takes none stays at infinity.  Then each block sums its
// accumulators with the complete add as a halving tree in shared memory
// (ops/curve.py sum_points' order), writes its sum, and takes a ticket
// (__threadfence, then atomicAdd on a device word); the block that takes
// the last one sums the blocks' sums with the same tree, writes the MSM
// [3, 12] and sets the word back to 0, so the next launch, and a replayed
// CUDA graph, find it at 0.  ops/msm.py msm_point_plain follows the same
// grouping and order, so the point is the same words.
//
// What bounds M2.  Operations: 11 Fp products a selection (12 in the phi
// half) at ~600 32-bit multiply-adds each, against 96 bytes of table read;
// the reduction adds A - 1 complete adds of 12 products.  Each accumulator
// runs its ~52 N / A dependent adds one after another, and the tree's
// levels run one after another on fewer and fewer points, so both parts
// are also bound by latency: A is the card's resident thread count.
//
// What the design does about it.
// - The accumulator and the formula's temporaries live in registers
//   (curve.cuh add_mixed).  The next selection's 96-byte entry is in
//   flight into the thread's two-entry ring in shared memory (cp.async)
//   while the current one is added, and the digit after it is in flight
//   into a register; a thread steps its (half * 26 + window, point)
//   without dividing.  Neighbouring threads take neighbouring points of
//   one window, so their digit and mask loads coalesce; the entries are
//   96-byte rows at different multiples.
// - One launch instead of M2 and a 16-launch K3 tree: the accumulators
//   never leave the SM, and the reduction's levels need no host.
// - In the trees, each complete add is spread over a group of 2, 4 or 8
//   lanes (curve.cuh add_lanes): its twelve products are two levels of six
//   independent ones.  A level takes the most lanes an add that keep it to
//   one round of the block, so a wide level wastes few lanes and a narrow
//   one waits for two products instead of the twelve of K3's one-thread
//   add (curve.cuh add_staged).  The caller picks A and T (ops/msm.py, from
//   chip_smoke.py's sweep on the card).
// - Tensor cores and TMA have nothing to offer: every operand is a
//   different 12-word integer, and the entries are gathered, not tiled.
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
constexpr int kScratchVecs = 36;  // of a lane group's scratch in M2's trees (12 coordinates)
// M2's blocks at most (ops/msm.py MAX_BLOCKS): the last block holds every
// block's sum in shared memory, 144 bytes each.
constexpr int kMaxBlocks = 1024;

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

// The two GLV halves of k from m1 = floor(k G1C / 2^264): m2' = [k >=
// ceil(r / 2)], k1 = k - (m1 z^2 + m2') and k2 = m2' (z^2 - 1) - m1, both
// below 2^128 in magnitude; half 0 or 1's magnitude (words 0..4, word 5
// zero) and sign.
__device__ __forceinline__ void glv_halves(const uint32_t* k, const uint32_t* m1, int half, uint32_t* mag, bool& neg) {
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
  uint32_t z2[4], u[8];
#pragma unroll
  for (int j = 0; j < 4; j++) z2[j] = z2_word(j);
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
  for (int j = 0; j < 6; j++) mag[j] = half == 0 ? (j < 5 ? d1[j] : 0u) : (j < 4 ? d2[j] : 0u);
  neg = half == 0 ? neg1 : neg2;
}

// M1: k [m, 8] canonical Fr -> digits [2, 26, m] int8 (half 0: k1, half 1: k2).
__global__ void __launch_bounds__(128) glv_digits_kernel(const uint4* __restrict__ scalars,
                                                        int8_t* __restrict__ out, uint32_t m) {
  const uint32_t i = blockIdx.x * 128 + threadIdx.x;
  if (i >= m) return;
  uint32_t k[8];
  load_vec<8>(k, scalars + (size_t)i * 2);

  uint32_t g1c[5];
#pragma unroll
  for (int j = 0; j < 5; j++) g1c[j] = g1c_word(j);

  // m1 = floor(k G1C / 2^264): k G1C < 2^392, so m1 < 2^128.
  uint32_t prod[13], m1[4];
  mul_words<8, 5>(prod, k, g1c);
#pragma unroll
  for (int j = 0; j < 4; j++) m1[j] = (prod[8 + j] >> 8) | (prod[9 + j] << 24);

  uint32_t mag1[6], mag2[6];
  bool neg1, neg2;
  glv_halves(k, m1, 0, mag1, neg1);
  glv_halves(k, m1, 1, mag2, neg2);
  recode32(mag1, neg1, out + i, m);
  recode32(mag2, neg2, out + (size_t)kWindows * m + i, m);
}

// M1 over G lanes a scalar (G = 8: on the H100 4 lanes ran no faster),
// kDigitScalars scalars a block.  Every lane of the scalar's group loads
// it whole.
// - m1 = floor(k G1C / 2^264) by columns: lane r takes rows r + G t of the
//   8 x 5-word product (k_i G1C, 6 words each), one shuffle a row word
//   moves word d of each row to the lane that owns its column i + d
//   (columns r + G u), so each lane sums its columns (below 6 x 2^32).
//   Each column's high part moves up one column (a shuffle), which leaves
//   33-bit columns whose carries are one bit: a column generates one when
//   it is 2^32 or more and propagates one when it is 2^32 - 1, the group's
//   ballots give both masks, and (gen + prop) ^ gen ^ prop is every
//   column's carry in at once (field.cuh lane_mul's lookahead).  The five
//   words of m1 then go to every lane (five shuffles).
// - m2', k1 and k2 as the one-thread design, in every lane (short).
// - The recoding: lanes 0 .. G/2 - 1 take the k1 half, the others k2; lane
//   q of a half takes windows q + (G/2) t.  A window generates a carry when
//   its raw value is 17 or more and propagates one when it is exactly 16
//   (a digit above 16 borrows 32 from the next window): two ballots a step
//   of t give the half's 26-bit masks, and the same add gives every
//   window's carry in, so no window waits for the one below.
// - The digits go through shared memory as [52 rows][kDigitScalars], so
//   that each row's kDigitScalars bytes leave as two 16-byte stores and a
//   warp's stores cover 16 whole 32-byte sectors of the [2, 26, m] layout.
constexpr int kDigitScalars = 32;

template <int G>
__global__ void __launch_bounds__(kDigitScalars * G) glv_digits_lanes_kernel(const uint4* __restrict__ scalars,
                                                                             int8_t* __restrict__ out, uint32_t m) {
  constexpr int RT = 8 / G;                 // rows of the product a lane
  constexpr int CU = (13 + G - 1) / G;      // columns a lane
  constexpr int Q = G / 2;                  // lanes a half
  constexpr int TW = (kWindows + Q - 1) / Q;  // windows a lane
  __shared__ __align__(16) int8_t dig[2 * kWindows][kDigitScalars];
  const int r = threadIdx.x % G;
  const uint32_t sc = threadIdx.x / G;
  const uint32_t first = blockIdx.x * kDigitScalars;
  const uint32_t at = min(first + sc, m - 1);
  const unsigned base = threadIdx.x % 32 / G * G;
  uint32_t k[8];
  load_vec<8>(k, scalars + (size_t)at * 2);

  // The rows k_i G1C for i = r + G t.
  uint32_t row[RT][6];
#pragma unroll
  for (int t = 0; t < RT; t++) {
    uint32_t ki = k[0];
#pragma unroll
    for (int j = 1; j < 8; j++) ki = j == r + G * t ? k[j] : ki;
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 5; j++) {
      const uint64_t p = (uint64_t)ki * g1c_word(j) + carry;
      row[t][j] = (uint32_t)p;
      carry = p >> 32;
    }
    row[t][5] = (uint32_t)carry;
  }
  // Word d of row src + G t, src = (r - d) mod G, lies in column
  // src + G t + d = r + G (e + t): slot e + t of this lane.
  uint64_t col[CU];
#pragma unroll
  for (int u = 0; u < CU; u++) col[u] = 0;
#pragma unroll
  for (int d = 0; d < 6; d++) {
    const int src = (r - d + 8 * G) % G, e = (src + d - r) / G;
#pragma unroll
    for (int t = 0; t < RT; t++) {
      const uint32_t v = __shfl_sync(kFullWarp, row[t][d], src, G);
#pragma unroll
      for (int u = t; u < CU; u++) col[u] += u == e + t ? v : 0u;
    }
  }
  // Move each column's high part (below 6) into the next column, then
  // resolve the one-bit carries by lookahead over the group's ballots.
  uint64_t tcol[CU];
  unsigned gen = 0, prop = 0;
#pragma unroll
  for (int u = 0; u < CU; u++) {
    const uint32_t below = __shfl_sync(kFullWarp, (uint32_t)(col[u] >> 32), (r + G - 1) % G, G);
    const uint32_t below0 = u == 0 ? 0u : __shfl_sync(kFullWarp, (uint32_t)(col[u - 1] >> 32), G - 1, G);
    tcol[u] = (uint64_t)(uint32_t)col[u] + (r > 0 ? below : below0);
    const bool g_bit = tcol[u] >> 32, p_bit = g_bit || (uint32_t)tcol[u] == ~0u;
    gen |= ((__ballot_sync(kFullWarp, g_bit) >> base) & ((1u << G) - 1)) << (G * u);
    prop |= ((__ballot_sync(kFullWarp, p_bit) >> base) & ((1u << G) - 1)) << (G * u);
  }
  const unsigned carries = (gen + prop) ^ gen ^ prop;  // bit c: the carry into column c
  uint32_t word[CU];
#pragma unroll
  for (int u = 0; u < CU; u++) word[u] = (uint32_t)tcol[u] + (carries >> (r + G * u) & 1u);
  // m1 = words 8..12 shifted down by 8 bits: k G1C < 2^392, so m1 < 2^128.
  uint32_t top[5], m1[4];
#pragma unroll
  for (int c = 8; c < 13; c++) top[c - 8] = __shfl_sync(kFullWarp, word[c / G], c % G, G);
#pragma unroll
  for (int j = 0; j < 4; j++) m1[j] = (top[j] >> 8) | (top[j + 1] << 24);

  uint32_t mag[6];
  bool neg;
  glv_halves(k, m1, r < Q ? 0 : 1, mag, neg);

  // Lane q of the half: windows q + Q t, read from mag >> 5q at bit 5 Q t.
  const int h = r / Q, q = r % Q;
  uint32_t sh[6];
#pragma unroll
  for (int j = 0; j < 5; j++) sh[j] = __funnelshift_r(mag[j], mag[j + 1], 5 * q);
  sh[5] = 0;
  uint32_t raw[TW];
  gen = prop = 0;
#pragma unroll
  for (int t = 0; t < TW; t++) {
    const int bit = 5 * Q * t, w = bit >> 5, off = bit & 31;
    uint32_t v = sh[w] >> off;
    if (off > 27) v |= sh[w + 1] << (32 - off);
    raw[t] = q + Q * t < kWindows ? v & 31u : 0u;
    gen |= ((__ballot_sync(kFullWarp, raw[t] >= 17) >> (base + h * Q)) & ((1u << Q) - 1)) << (Q * t);
    prop |= ((__ballot_sync(kFullWarp, raw[t] >= 16) >> (base + h * Q)) & ((1u << Q) - 1)) << (Q * t);
  }
  const unsigned wcarry = (gen + prop) ^ gen ^ prop;  // bit j: the carry into window j
#pragma unroll
  for (int t = 0; t < TW; t++) {
    const int j = q + Q * t;
    if (j < kWindows) {
      const int digit = (int)raw[t] + (int)(wcarry >> j & 1u) - 32 * (int)(wcarry >> (j + 1) & 1u);
      dig[h * kWindows + j][sc] = (int8_t)(neg ? -digit : digit);
    }
  }
  __syncthreads();
  if (first + kDigitScalars <= m && m % 16 == 0) {
    for (int v = threadIdx.x; v < 2 * kWindows * 2; v += kDigitScalars * G)
      *(uint4*)(out + (size_t)(v >> 1) * m + first + 16 * (v & 1)) = *(const uint4*)&dig[v >> 1][16 * (v & 1)];
  } else {
    for (int v = threadIdx.x; v < 2 * kWindows * kDigitScalars; v += kDigitScalars * G)
      if (first + v % kDigitScalars < m) out[(size_t)(v / kDigitScalars) * m + first + v % kDigitScalars] = dig[v / kDigitScalars][v % kDigitScalars];
  }
}

// cp.async of 16 bytes from device memory into shared memory (L2 only), and
// the group fences: every copy of a thread lands before its wait_group
// returns, the newest N groups excepted.
__device__ __forceinline__ void copy_async(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One selection of a thread: s = hw * n + point, hw = half * 26 + window.
struct Sel {
  uint32_t s, point, hw;
  int d;  // its digit; 0 past the end, for a zero digit and for an infinity base
};

__device__ __forceinline__ void load_digit(Sel& q, const int8_t* __restrict__ digits,
                                           const uint8_t* __restrict__ inf, uint32_t total) {
  q.d = q.s < total && !inf[q.point] ? digits[q.s] : 0;
}

// The next selection of the thread, accs further on, without a division.
__device__ __forceinline__ Sel step(Sel q, uint32_t accs, uint32_t step_hw, uint32_t step_point,
                                    uint32_t n) {
  q.s += accs;
  q.hw += step_hw;
  q.point += step_point;
  if (q.point >= n) {
    q.point -= n;
    q.hw++;
  }
  return q;
}

// The table entry table[window, |d| - 1, point] of a selection into
// dst[0..5], when its digit is not 0.
__device__ __forceinline__ void fetch_entry(uint4* dst, const Sel& q, const uint4* __restrict__ table,
                                            uint32_t n) {
  if (q.d == 0) return;
  const uint32_t w = q.hw < kWindows ? q.hw : q.hw - kWindows;
  const uint32_t mag = q.d < 0 ? -q.d : q.d;
  const uint4* e = table + ((size_t)(w * kMultiples + mag - 1) * n + q.point) * kEntryVecs;
#pragma unroll
  for (int k = 0; k < kEntryVecs; k++) copy_async(dst + k, e + k);
}

// The adds i < h of a tree level, slot i += slot i + h: group g of G lanes
// takes adds g, g + T / G, ... (curve.cuh add_lanes, with its scratch).
template <int T, int G>
__device__ __forceinline__ void tree_level(uint4* slots, uint32_t h, uint4* scratch) {
  const uint32_t g = threadIdx.x / G;
  const int r = threadIdx.x % G;
  const unsigned mask = ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
  for (uint32_t i = g; i < h; i += T / G)
    add_lanes<G>(slots + i * kPointVecs, slots + (i + h) * kPointVecs, scratch + g * kScratchVecs, r, mask);
}

// The halving tree over the w points of slots[0..w-1] (9 vectors each):
// slot i += slot i + w/2 for i < w/2, an odd width carrying its last point
// to slot w/2, until slot 0 holds the sum: ops/curve.py sum_points' order.
// Each level spreads an add over the most lanes (2, 4 or 8) that keep the
// level to one round of the block's threads: a wide level then wastes the
// fewest lanes and instructions, a narrow one waits for two products
// instead of twelve.  Every thread of the block calls it.  Not inlined:
// its registers are then allocated apart from the accumulation loop's,
// which spills less (ptxas, chip_smoke.py phase 1).
template <int T>
__device__ __noinline__ void tree_sum(uint4* slots, uint32_t w, uint4* scratch) {
  while (w > 1) {
    const uint32_t h = w / 2;
    if (8 * h <= T)
      tree_level<T, 8>(slots, h, scratch);
    else if (4 * h <= T)
      tree_level<T, 4>(slots, h, scratch);
    else
      tree_level<T, 2>(slots, h, scratch);
    __syncthreads();
    if (w & 1) {
      if (threadIdx.x < kPointVecs) slots[h * kPointVecs + threadIdx.x] = slots[(w - 1) * kPointVecs + threadIdx.x];
      __syncthreads();
    }
    w = h + (w & 1);
  }
}

// M2: see the head of the file.  table [26, 16, n, 2, 12], inf [n] (0 or 1),
// digits [2, 26, n] -> out [3, 12], the MSM; partials [gridDim.x, 3, 12] is
// scratch for the blocks' sums and ticket a zero word that the last block
// sets back to zero.  step_hw and step_point are accs / n and accs % n.
// At most 384 / T blocks of T threads share an SM's registers (168 a
// thread), so that 384 accumulators an SM run in one wave.
template <int T>
__global__ void __launch_bounds__(T, 384 / T) msm_glv_kernel(
    const uint4* __restrict__ table, const uint8_t* __restrict__ inf,
    const int8_t* __restrict__ digits, uint4* __restrict__ partials, unsigned* __restrict__ ticket,
    uint4* __restrict__ out, uint32_t n, uint32_t accs, uint32_t step_hw, uint32_t step_point) {
  extern __shared__ uint4 smem[];
  __shared__ bool last;
  const uint32_t nblocks = gridDim.x;
  // The trees' slots (max(T, blocks) points), then the lane groups'
  // scratch.  The prefetch ring, two entries a thread, lies over the slots:
  // it is spent before the first slot is written.
  uint4* const slots = smem;
  uint4* const scratch = smem + (size_t)max((uint32_t)T, nblocks) * kPointVecs;
  uint4* const ring = smem + threadIdx.x * 2 * kEntryVecs;

  Elt zero, one, beta;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) {
    zero.w[j] = 0;
    one.w[j] = one_mont_word(j);
    beta.w[j] = beta_mont_word(j);
  }
  Elt X = zero, Y = one, Z = zero;  // infinity
  const uint32_t a = blockIdx.x * T + threadIdx.x;
  const uint32_t total = 2u * kWindows * n;
  bool started = false;  // the first selection is taken as (x, y, 1), not added onto infinity
  if (a < accs) {
    // Selections k (added now), k + 1 (its entry in flight into the ring)
    // and k + 2 (its digit in flight).
    Sel cur = {a, a % n, a / n, 0};
    load_digit(cur, digits, inf, total);
    Sel nxt = step(cur, accs, step_hw, step_point, n);
    load_digit(nxt, digits, inf, total);
    fetch_entry(ring, cur, table, n);
    copy_commit();
    for (uint32_t k = 0; cur.s < total; k++) {
      Sel after = step(nxt, accs, step_hw, step_point, n);
      load_digit(after, digits, inf, total);
      fetch_entry(ring + ((k + 1) & 1) * kEntryVecs, nxt, table, n);
      copy_commit();
      copy_wait<1>();
      if (cur.d != 0) {
        const uint4* e = ring + (k & 1) * kEntryVecs;
        Elt x = lds(e);
        Elt y = lds(e + 3);
        if (cur.hw >= kWindows) x = mul(x, beta);
        if (cur.d < 0) y = sub(zero, y);
        if (started) {
          add_mixed(X, Y, Z, x, y);
        } else {
          X = x;
          Y = y;
          Z = one;
          started = true;
        }
      }
      cur = nxt;
      nxt = after;
    }
  }
  copy_wait<0>();
  __syncthreads();  // the ring is spent

  // The block's accumulators (m of them in a ragged last block) to its sum.
  const uint32_t m = min((uint32_t)T, accs - blockIdx.x * T);
  if (threadIdx.x < m) {
    uint4* o = slots + threadIdx.x * kPointVecs;
    sts(o, X);
    sts(o + 3, Y);
    sts(o + 6, Z);
  }
  __syncthreads();
  tree_sum<T>(slots, m, scratch);

  // The last block to finish sums the blocks' sums.
  if (threadIdx.x < kPointVecs) partials[(size_t)blockIdx.x * kPointVecs + threadIdx.x] = slots[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == nblocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (uint32_t k = threadIdx.x; k < nblocks * kPointVecs; k += T) slots[k] = __ldcg(partials + k);
  __syncthreads();
  tree_sum<T>(slots, nblocks, scratch);
  if (threadIdx.x < kPointVecs) out[threadIdx.x] = slots[threadIdx.x];
  if (threadIdx.x == 0) *ticket = 0;
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

// Dynamic shared memory of one M2 block: the larger of the prefetch ring
// and the trees' slots with the lane groups' scratch.
size_t msm_smem_bytes(int t, long long nblocks) {
  const size_t ring = (size_t)t * 2 * kEntryVecs;
  const size_t trees = (size_t)(nblocks > t ? nblocks : t) * kPointVecs + (size_t)(t / 2) * kScratchVecs;
  return 16 * (ring > trees ? ring : trees);
}

template <int T>
int launch_msm(const void* table, const void* inf, const void* digits, void* partials, void* ticket,
               void* out, long long n, long long accs, cudaStream_t s) {
  const long long nblocks = (accs + T - 1) / T;
  const size_t smem = msm_smem_bytes(T, nblocks);
  // Raised once per instantiation and size, outside any graph capture: the
  // first launch of a process is never captured (chip_smoke.py and the path
  // warm up).
  static size_t raised = 0;
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(msm_glv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  msm_glv_kernel<T><<<(unsigned)nblocks, T, smem, s>>>(
      (const uint4*)table, (const uint8_t*)inf, (const int8_t*)digits, (uint4*)partials,
      (unsigned*)ticket, (uint4*)out, (uint32_t)n, (uint32_t)accs, (uint32_t)(accs / n),
      (uint32_t)(accs % n));
  return (int)cudaGetLastError();
}

}  // namespace

// M1: scalars [m, 8] -> digits [2, 26, m]; `lanes` a scalar: 8 is the
// lane design, 1 the one-thread design.
extern "C" int kzg_glv_digits(const void* scalars, void* out, long long m, long long lanes, void* stream) {  // M1
  if (!aligned(scalars) || !aligned(out) || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1:
      glv_digits_kernel<<<blocks(m, 128), 128, 0, s>>>((const uint4*)scalars, (int8_t*)out, (uint32_t)m);
      break;
    case 8:
      glv_digits_lanes_kernel<8><<<blocks(m, kDigitScalars), kDigitScalars * 8, 0, s>>>(
          (const uint4*)scalars, (int8_t*)out, (uint32_t)m);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_msm_glv(const void* table, const void* inf, const void* digits, void* partials,
                           void* ticket, void* out, long long n, long long accs, long long block,
                           void* stream) {  // M2
  if (!aligned(table) || !aligned(partials) || !aligned(out)) return (int)cudaErrorInvalidValue;
  if (n < 1 || accs < 1 || block < 1 || (accs + block - 1) / block > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 128: return launch_msm<128>(table, inf, digits, partials, ticket, out, n, accs, s);
    case 256: return launch_msm<256>(table, inf, digits, partials, ticket, out, n, accs, s);
    case 384: return launch_msm<384>(table, inf, digits, partials, ticket, out, n, accs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int kzg_proj_add_mixed(const void* p, const void* q, void* out, long long n,
                                  void* stream) {
  if (!aligned(p) || !aligned(q) || !aligned(out)) return (int)cudaErrorInvalidValue;
  proj_add_mixed_kernel<<<blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint4*)p, (const uint4*)q, (uint4*)out, (uint32_t)n);
  return (int)cudaGetLastError();
}
