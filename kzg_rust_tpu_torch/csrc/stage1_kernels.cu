// Verification's stage 1 for Hopper (sm_90a) as three launches: kernel A,
// kzg_g1_decompress (G1 decompression with its square root), then the K4
// chain of curve_kernels.cu (the 131 doublings of the window bases), then
// kernel B, kzg_g1_subgroup_check (the GLV subgroup check over the chain's
// rows).  Nothing but allocations lies between them on the host, and the
// stage's two flags stay on the card until the batch's one fetch.
//
// A and B replace the rest of the XLA program of the JAX package's
// kzg_rust_tpu/ops/verify_kernels.py:212 batch_points: A its :73
// g1_uncompress_points, B its :166 subgroup_check_from_bases and the flags
// of :212.  On the TPU that program ran on K1's product (pallas_kernels.py
// :248, whose core runs inside both here) and K3's complete add (:348,
// which B takes over four lanes); the port ran it as 29 launches of K1, K3,
// the Fp chain and the small Fp launchers, with ~25 tensor ops between.
//
// A, L lanes a point (4 or 2 by the width, ops/verify_kernels.py
// decompress_lanes; 1 is the one-thread design, kept for comparison):
// the flag bits, the 48 big-endian bytes as 12 little-endian words, x < p
// (a non-canonical x is clamped to 0, so the Montgomery steps stay in
// range), to_mont, x^3 + 4, the square root rhs^((p+1)/4), y^2 == rhs, the
// sign test on from_mont(y) and the conditional negation, and the strict
// infinity encoding: the rules of the JAX g1_uncompress_points (:73-111).
// Each value is the canonical integer of the same field operations, so
// every row, valid or not, gets the words of the plain version
// (ops/verify_kernels.py g1_uncompress_points_plain).  It writes the
// projective point, the row's ok, and sets both stage-1 flags to 1 for B to
// clear.  Bound: operations, the chain's 375 squarings and 82 products
// (sliding windows of 5 bits over the odd powers x .. x^31; the 4-bit
// fixed windows took 376 and 105) and five more products and squarings.
// A is latency-bound: the chain is ~460 dependent products, and at 2 npad
// = 128 or 8,192 points one thread a point puts 4 or 256 warps on 528 SM
// sub-partitions.  So each product of the chain is spread over the point's
// L lanes (field.cuh lane_mul: each lane runs W = 12 / L words of both
// CIOS rows, two shuffles a word of the multiplier, carry lookahead by
// ballot at the end), which cuts the instructions on a product's path and
// puts L times the warps on the card; the table is laid out by lane.  The
// decode and the steps after the chain are short and run in every lane.
//
// B: [z^2]P as the halving tree of ops/curve.py sum_points over the 17
// chain rows that the nonzero signed base-4 digits of z^2 name (kZ2Digits:
// |d| = 2 takes 2 4^j P, a -1 digit negates Y as the row is loaded); then
// phi(P) == -[z^2]P by cross products, with infinity passing: the rules of
// the JAX subgroup_check_from_bases (:166-196).  The tree's pairs are the
// plain version's, so the sum has the same projective words and every row
// the same bit, decoded or not.  Each block ANDs its rows' bits, and A's
// decode bits, with __syncthreads_and; a block with a failing row stores 0
// into the flag.  Bound: operations, 16 adds of 12 Fp products and 5
// products a point.
//
// What bounds A and B at the path's widths (2 npad = 128 or 8,192 points)
// is latency at 128 points, where the card is mostly idle: A's chain of
// dependent products (above), and B's sum, which the serial design runs as 16
// adds one after another over 4 lanes (curve.cuh add_lanes: two products
// a level on lanes 0-1), about 64 dependent products a point, with 4 of
// 132 SMs at work.  At 8,192 points the card is full and the work each
// point runs decides.
//
// B's level-parallel design (subgroup_tree_kernel).  17 = 16 + 1, so the
// tree's odd widths always carry part 16: it is the perfect tree over
// parts 0-15, then one add of part 16.  A point has P lane groups of G
// lanes; a level's adds run side by side, one a group (8, 4, 2, 1 and 1
// adds), each over its group's lanes (add_lanes_from), with a barrier
// between levels; the first level reads its parts straight from the chain
// rows, and while group 0 takes the last add, group 1 forms beta X1.  A
// point keeps 8 slots and P scratch areas in shared memory (2,304 to
// 5,760 bytes, against the serial design's 2,016); at 8,192 points every
// block of the (2, 2) variant is resident at once (6 blocks an SM fit by
// registers and by shared memory, 3.9 are needed).  The variant is the
// width's (ops/verify_kernels.py
// subgroup_lanes): 8 groups of 8 lanes where the card is idle (a point
// waits for 5 levels of two products, and each of 8 lanes forms one
// second-level operand), 4 groups of 8 in the middle, and 2 groups of 2
// lanes where it is full (fewer lanes repeat an add's operand work, and
// the narrowing levels idle less).  The serial design stays as the
// variant (4, 1), for comparison.  The launch cost that held stage 1 back (30 launches
// from Python, each at a few microseconds of card time for a fraction of a
// microsecond of work) is three launches.  Tensor cores and TMA have
// nothing to offer: every operand is a different 12-word integer.
//
// C interface as in field_kernels.cu: launch on the given stream, return
// cudaGetLastError().  Points, rows and compressed inputs start on 16 bytes
// (the entry points return cudaErrorInvalidValue otherwise).

#include <cuda_runtime.h>

#include <cstring>

#include "curve.cuh"

using namespace kzg;

namespace {

constexpr int kVecs = 9;          // 16-byte vectors of a projective point; 3 a coordinate
constexpr int kScratchVecs = 36;  // of a lane group's scratch (add_lanes_from: 12 coordinates)
constexpr int kLanes = 4;         // the serial B's lanes a point
constexpr int kWindows = 66;      // signed base-4 windows of z^2
constexpr int kParts = 17;        // its nonzero digits
constexpr int kSlots = 10;        // the serial B's points in shared memory a point: 9 tree slots, 1 staged row
constexpr int kTreeSlots = 8;     // the level-parallel B's: the first level's eight sums
constexpr int kTreeBlock = 64;    // the level-parallel B's threads a block

// The signed base-4 digits of z^2, least significant first: ops/glv.py
// recode_base4_signed([Z2]) (the CPU tests parse this array).
constexpr int kZ2Digits[kWindows] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 1, 2, 2, 1, 0, 0, 0,
    0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 2, 2, 1, 1, 0, 1, 0, -1, -1, -1, 1, 0};

constexpr int nonzero_digits() {
  int c = 0;
  for (int j = 0; j < kWindows; j++) c += kZ2Digits[j] != 0;
  return c;
}
static_assert(nonzero_digits() == kParts, "z^2 has 17 nonzero signed base-4 digits");

// (p + 1) / 4, the square root's exponent, as little-endian words.
constexpr uint32_t kSqrtExp[Fp::N] = {0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu,
                                      0x3dac3d89u, 0xd9cc34a8u, 0x3ce144afu, 0xd91dd2e1u,
                                      0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au};

// The square root's chain, by value in a kernel parameter (the constant
// bank, read by a warp at one address; a CUDA graph captures it): a table
// of the `entries` odd powers x^(2k - 1), k = 1 .. entries (after x^2),
// then `steps` steps, step 0 taking entry idx[0] and step k squaring sq[k]
// times and multiplying by entry idx[k] (none for 0).  The host builds it
// (ops/limbs.py pow_chain, sliding 5-bit windows) and the entry point
// refuses one that does not make kSqrtExp.
constexpr int kChainMaxSteps = 128;
constexpr int kChainMaxEntries = 16;

struct SqrtChain {
  uint8_t sq[kChainMaxSteps];
  uint8_t idx[kChainMaxSteps];
  uint32_t steps, entries;
};

// e = e 2^s + v over 13 words; false when a bit leaves the top word.
bool shift_add(uint32_t* e, int s, uint32_t v) {
  for (; s > 0; s--) {
    if (e[Fp::N] >> 31) return false;
    for (int j = Fp::N; j > 0; j--) e[j] = e[j] << 1 | e[j - 1] >> 31;
    e[0] <<= 1;
  }
  for (int j = 0; j <= Fp::N && v; j++) {
    const uint64_t t = (uint64_t)e[j] + v;
    e[j] = (uint32_t)t;
    v = (uint32_t)(t >> 32);
  }
  return v == 0;
}

// Bytes entries, then (sq, idx) a step -> the chain; false for a malformed
// chain or one that does not make (p + 1) / 4.
bool parse_chain(const uint8_t* b, long long len, SqrtChain& ch) {
  if (b == nullptr || len < 3 || len % 2 == 0 || (len - 1) / 2 > kChainMaxSteps) return false;
  ch = SqrtChain{};
  ch.entries = b[0];
  ch.steps = (uint32_t)((len - 1) / 2);
  if (ch.entries < 1 || ch.entries > kChainMaxEntries) return false;
  uint32_t e[Fp::N + 1] = {};
  for (uint32_t k = 0; k < ch.steps; k++) {
    ch.sq[k] = b[1 + 2 * k];
    ch.idx[k] = b[2 + 2 * k];
    if (ch.idx[k] > ch.entries || (k == 0 && (ch.idx[0] == 0 || ch.sq[0] != 0))) return false;
    if (!shift_add(e, ch.sq[k], ch.idx[k] ? 2 * ch.idx[k] - 1 : 0)) return false;
  }
  for (int j = 0; j < Fp::N; j++)
    if (e[j] != kSqrtExp[j]) return false;
  return e[Fp::N] == 0;
}

// A constant Fp element as immediates, NAME() (the CPU tests parse these
// lines against the Python constants).
#define KZG_CONSTANT(NAME, ...)                            \
  __device__ __forceinline__ Elt NAME() {                  \
    constexpr uint32_t w[Fp::N] = {__VA_ARGS__};           \
    Elt r;                                                 \
    for (int j = 0; j < Fp::N; j++) r.w[j] = w[j];         \
    return r;                                              \
  }

KZG_CONSTANT(r2_mod_p, 0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu,
             0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u)  // R^2 mod p
KZG_CONSTANT(one_mont, 0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
             0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u)  // R mod p
KZG_CONSTANT(b4_mont, 0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au,
             0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u)  // 4 R mod p
KZG_CONSTANT(half_p1, 0xffffd556u, 0xdcff7fffu, 0x58a9ffffu, 0x0f55ffffu, 0x7b587b12u, 0xb3986950u,
             0x79c2895fu, 0xb23ba5c2u, 0x21a5d66bu, 0x258dd3dbu, 0x1cbff34du, 0x0d0088f5u)  // (p+1)/2
KZG_CONSTANT(beta_mont, 0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au,
             0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu)  // beta R mod p

__device__ __forceinline__ Elt zero() {
  Elt r;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) r.w[j] = 0;
  return r;
}

__device__ __forceinline__ Elt modulus() {
  Elt r;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) r.w[j] = fp_mod_word(j);
  return r;
}

__device__ __forceinline__ Elt sqr(const Elt& a) {
  Elt r;
  fp_mont_sqr(r.w, a.w);
  return r;
}

__device__ __forceinline__ bool is_zero(const Elt& a) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) any |= a.w[j];
  return any == 0;
}

__device__ __forceinline__ bool equal(const Elt& a, const Elt& b) {
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) diff |= a.w[j] ^ b.w[j];
  return diff == 0;
}

// a >= b as integers: the most significant differing word decides.
__device__ __forceinline__ bool geq(const Elt& a, const Elt& b) {
  bool ge = true, eq = true;
#pragma unroll
  for (int j = Fp::N - 1; j >= 0; j--) {
    if (eq && a.w[j] != b.w[j]) {
      ge = a.w[j] > b.w[j];
      eq = false;
    }
  }
  return ge;
}

// A chain product on this lane's part: the lane product for L > 1, the
// one-thread CIOS product for L = 1 (canonical, so below 2p too).
template <int L>
__device__ __forceinline__ void chain_mul(uint32_t* out, const uint32_t* a_part, const uint32_t* b,
                                          const uint32_t* m_part, int r) {
  if constexpr (L == 1) cios_mul<Fp>(out, a_part, b); else lane_mul<L>(out, a_part, b, m_part, r);
}

// acc <- acc * a over the group (a this lane's part; b is acc whole).
template <int L>
__device__ __forceinline__ void chain_step(uint32_t* acc, const uint32_t* a_part, const uint32_t* m_part, int r) {
  uint32_t b[Fp::N];
  if constexpr (L == 1) {
#pragma unroll
    for (int j = 0; j < Fp::N; j++) b[j] = acc[j];
  } else {
    lane_gather<L>(b, acc);
  }
  chain_mul<L>(acc, a_part, b, m_part, r);
}

// acc <- acc^2 over the group; one thread takes the SOS squaring.
template <int L>
__device__ __forceinline__ void chain_square(uint32_t* acc, const uint32_t* m_part, int r) {
  if constexpr (L == 1) {
    sos_sqr<Fp>(acc, acc);
  } else {
    uint32_t a[Fp::N / L];
#pragma unroll
    for (int j = 0; j < Fp::N / L; j++) a[j] = acc[j];
    chain_step<L>(acc, a, m_part, r);
  }
}

// y = x^((p+1)/4) (Montgomery, canonical, whole in every lane of the group)
// by the chain ch, for x < p whole in every lane.  The group's lanes hold
// W = 12 / L words each of every value of the chain; the table lies in this
// thread's column `col` of the block's dynamic shared memory, [entry][word
// of the part][thread] for T threads, so each lane keeps its own part.
template <int T, int L>
__device__ __forceinline__ void sqrt_chain(uint32_t* y, const uint32_t* x, uint32_t* col, const SqrtChain& ch, int r) {
  constexpr int W = Fp::N / L;
  uint32_t m[W], acc[W], base[Fp::N];
  const Elt p = modulus();
  lane_part<L>(m, p.w, r);
  lane_part<L>(acc, x, r);
#pragma unroll
  for (int j = 0; j < Fp::N; j++) base[j] = x[j];
  table_put<W, T>(col, 1, acc);
  if (ch.entries > 1) {  // the odd powers step by x^2
    uint32_t sq[W];
    chain_mul<L>(sq, acc, x, m, r);
    if constexpr (L == 1) {
#pragma unroll
      for (int j = 0; j < Fp::N; j++) base[j] = sq[j];
    } else {
      lane_gather<L>(base, sq);
    }
  }
#pragma unroll 1
  for (uint32_t k = 2; k <= ch.entries; k++) {
    chain_mul<L>(acc, acc, base, m, r);
    table_put<W, T>(col, k, acc);
  }
  table_get<W, T>(acc, col, ch.idx[0]);
#pragma unroll 1
  for (uint32_t k = 1; k < ch.steps; k++) {
#pragma unroll 1
    for (uint32_t s = 0; s < ch.sq[k]; s++) chain_square<L>(acc, m, r);
    const uint32_t d = ch.idx[k];
    if (d) {
      uint32_t e[W];
      table_get<W, T>(e, col, d);
      chain_step<L>(acc, e, m, r);
    }
  }
  if constexpr (L == 1) {
#pragma unroll
    for (int j = 0; j < Fp::N; j++) y[j] = acc[j];
  } else {
    lane_gather<L>(y, acc);
    fp_reduce_once(y, y);  // the lane products leave it below 2p
  }
}

// Kernel A over L lanes a point.  comp [n, 48] uint8 -> out [n, 3, 12]
// projective Montgomery points, ok [n] (0 or 1); flags [2], when given, set
// to 1.  Every lane of a group decodes its point's row (the same words in
// each), the chain runs over the group, and lane 0 stores.  A group past n
// decodes row n - 1 and stores nothing, so every warp's shuffles are whole.
template <int T, int L>
__global__ void __launch_bounds__(T) decompress_kernel(const uint4* __restrict__ comp,
                                                       uint4* __restrict__ out,
                                                       uint8_t* __restrict__ ok_out,
                                                       int* __restrict__ flags, uint32_t n,
                                                       const __grid_constant__ SqrtChain ch) {
  extern __shared__ uint32_t table[];
  const int r = threadIdx.x % L;
  const uint32_t i = blockIdx.x * (T / L) + threadIdx.x / L;
  if (flags != nullptr && blockIdx.x == 0 && threadIdx.x == 0) flags[0] = flags[1] = 1;
  const uint32_t row = min(i, n - 1);

  // The flag bits of byte 0, and the 48 big-endian bytes, those bits masked
  // off, as little-endian words (word j is bytes 44 - 4j .. 47 - 4j).
  uint32_t raw[Fp::N];
  load_vec<Fp::N>(raw, comp + (size_t)row * 3);
  const uint32_t bits = raw[0] & 0xffu;
  const bool comp_bit = bits & 0x80u, inf_bit = bits & 0x40u, sign_bit = bits & 0x20u;
  Elt x;
#pragma unroll
  for (int j = 0; j < Fp::N; j++) x.w[j] = __byte_perm(raw[Fp::N - 1 - j], 0, 0x0123);
  x.w[Fp::N - 1] &= 0x1fffffffu;
  const bool x_zero = is_zero(x);  // with the infinity bit: the strict encoding
  const bool x_ok = !geq(x, modulus());
  if (!x_ok) x = zero();

  Elt xm = mul(x, r2_mod_p());
  Elt rhs = add(mul(xm, sqr(xm)), b4_mont());
  // xm and rhs wait in shared memory, after the table, while the chain
  // runs, so that the chain has the registers: held live beside the
  // one-thread chain, they made it about 40% slower on the H100.
  uint4* const park = (uint4*)(table + (size_t)ch.entries * (Fp::N / L) * T) + threadIdx.x * 6;
  sts(park, xm);
  sts(park + 3, rhs);
  Elt y;
  sqrt_chain<T, L>(y.w, rhs.w, table + threadIdx.x, ch, r);
  xm = lds(park);
  rhs = lds(park + 3);
  const bool on_curve = equal(sqr(y), rhs);
  Elt unit = zero();
  unit.w[0] = 1;
  const bool y_large = geq(mul(y, unit), half_p1());  // from_mont(y) >= (p+1)/2
  if (y_large != sign_bit) y = sub(zero(), y);

  if (i >= n || r != 0) return;
  const bool ok = comp_bit && (inf_bit ? !sign_bit && x_zero : x_ok && on_curve);
  uint4* o = out + (size_t)i * kVecs;
  stg(o, inf_bit ? zero() : xm);
  stg(o + 3, inf_bit ? one_mont() : y);
  stg(o + 6, inf_bit ? zero() : one_mont());
  ok_out[i] = ok;
}

// B's parts: the chain row of each nonzero digit of z^2 in order of its
// window j (bases[j], or bases2[j] for |d| = 2), and a bit a part for a
// negative digit.  A kernel parameter: a lane reads row[k] at one address
// of the constant bank.
struct Parts {
  const uint4* row[kParts];
  uint32_t neg;
};

// Coordinate `coord` of point `at` of part k into dst, Y negated for a
// negative digit.
__device__ __forceinline__ void stage_coord(uint4* dst, const Parts& parts, int k, size_t at, int coord) {
  Elt v = ldg(parts.row[k] + at * kVecs + 3 * coord);
  if (coord == 1 && (parts.neg >> k & 1u)) v = sub(zero(), v);
  sts(dst + 3 * coord, v);
}

// Kernel B.  points [n, 3, 12] and the parts' rows -> sub_ok [n] (0 or 1);
// with flags, flag 1 cleared where a row fails and, with dec_ok [n] (A's
// ok), flag 0 where a row does not decode.  Lanes 4g .. 4g + 3 of a block
// take its point g; each group has ten points of the block's shared memory
// (slots 0-8 of the tree, slot 9 a staged row) and its add_lanes scratch.
template <int T>
__global__ void __launch_bounds__(T) subgroup_kernel(const uint4* __restrict__ points,
                                                     const __grid_constant__ Parts parts,
                                                     const uint8_t* __restrict__ dec_ok,
                                                     uint8_t* __restrict__ sub_ok,
                                                     int* __restrict__ flags, uint32_t n) {
  extern __shared__ uint4 smem[];
  constexpr int kPoints = T / kLanes;
  const uint32_t g = threadIdx.x / kLanes;
  const int r = threadIdx.x % kLanes;
  const uint32_t i = blockIdx.x * kPoints + g;
  const bool live = i < n;
  const unsigned mask = 0xfu << (threadIdx.x % 32 / kLanes * kLanes);
  uint4* const slots = smem + (size_t)g * kSlots * kVecs;
  uint4* const staged = slots + (kSlots - 1) * kVecs;
  uint4* const scratch = smem + (size_t)kPoints * kSlots * kVecs + g * kScratchVecs;
  bool in_group = true;
  if (live) {
    // The halving tree over the 17 parts: the first level adds part k + 8
    // onto part k (k < 8) as the rows are loaded and carries part 16 to
    // slot 8; the levels over the 9 slots follow.
#pragma unroll 1
    for (int k = 0; k < 8; k++) {
      for (int c = r; c < 6; c += kLanes)
        stage_coord(c < 3 ? slots + k * kVecs : staged, parts, c < 3 ? k : k + 8, i, c % 3);
      __syncwarp(mask);
      add_lanes<kLanes>(slots + k * kVecs, staged, scratch, r, mask);
    }
    if (r < 3) stage_coord(slots + 8 * kVecs, parts, kParts - 1, i, r);
    __syncwarp(mask);
#pragma unroll 1
    for (uint32_t w = 9; w > 1;) {
      const uint32_t h = w / 2;
#pragma unroll 1
      for (uint32_t k = 0; k < h; k++) add_lanes<kLanes>(slots + k * kVecs, slots + (k + h) * kVecs, scratch, r, mask);
      if (w & 1) {
        for (int v = r; v < kVecs; v += kLanes) slots[h * kVecs + v] = slots[(w - 1) * kVecs + v];
        __syncwarp(mask);
      }
      w = h + (w & 1);
    }

    // phi(P) = (beta X1, Y1, Z1) against -[z^2]P = (X2, -Y2, Z2): lane 0
    // takes beta X1 Z2, lane 1 X2 Z1, lane 2 Y1 Z2, lane 3 -Y2 Z1.
    const uint4* p = points + (size_t)i * kVecs;
    const Elt x1 = ldg(p), y1 = ldg(p + 3), z1 = ldg(p + 6);
    const Elt z2 = lds(slots + 6);
    const Elt phix = mul(x1, beta_mont());
    const Elt left = sel(r == 0, phix, sel(r == 1, lds(slots), sel(r == 2, y1, sub(zero(), lds(slots + 3)))));
    sts(scratch + 3 * r, mul(left, sel(r == 0 || r == 2, z2, z1)));
    __syncwarp(mask);
    if (r == 0) {
      const bool eq_x = equal(lds(scratch), lds(scratch + 3));
      const bool eq_y = equal(lds(scratch + 6), lds(scratch + 9));
      const bool inf_a = is_zero(z1), inf_b = is_zero(z2);
      in_group = (eq_x && eq_y && !inf_a && !inf_b) || (inf_a && inf_b);
      sub_ok[i] = in_group;
    }
  }
  if (flags != nullptr) {
    const bool lead = live && r == 0;
    if (!__syncthreads_and(!lead || in_group) && threadIdx.x == 0) flags[1] = 0;
    const bool decoded = !lead || dec_ok == nullptr || dec_ok[i] != 0;
    if (!__syncthreads_and(decoded) && threadIdx.x == 0) flags[0] = 0;
  }
}

// Coordinate c of part k's row for point `at`, Y negated for a negative
// digit: the level-parallel B reads its parts straight from the chain.
__device__ __forceinline__ Elt part_coord(const Parts& parts, int k, size_t at, int c) {
  const Elt v = ldg(parts.row[k] + at * kVecs + 3 * c);
  return c == 1 && (parts.neg >> k & 1u) ? sub(zero(), v) : v;
}

// The level-parallel B's barrier between two levels of a point's tree:
// its lanes, one warp's or (64 lanes) the whole block's.
template <int LANES>
__device__ __forceinline__ void level_sync(unsigned point_mask) {
  if constexpr (LANES > 32) __syncthreads(); else __syncwarp(point_mask);
}

// Kernel B, level-parallel: P groups of G lanes a point (lanes g G .. g G +
// G - 1 of the point's G P are group g), kTreeBlock / (G P) points a block.
// The same halving tree as sum_points over the 17 parts: since 17 = 16 + 1,
// its odd widths always carry part 16, so it is the perfect tree over
// parts 0-15 (level 1: slot k = part k + part k + 8 for k < 8, read
// straight from the chain rows; then slot k += slot k + h for h = 4, 2,
// 1) and, last, slot 0 += part 16.  A level's adds go to groups k mod P,
// side by side, each add over its group's G lanes (add_lanes_from), with a
// barrier between levels; while group 0 takes the last add, group 1 forms
// beta X1 into slot 1.  Then group 0's lanes 0-3 take the four cross
// products.  A point needs 8 slots and P scratch areas of shared memory.
// Every point runs every level (a point past n reads row n - 1 and stores
// nothing), so every barrier is whole.  The launch bound's minimum of one
// block an SM leaves ptxas the registers: without it ptxas held the kernel
// to 128 and spilled.
template <int G, int P>
__global__ void __launch_bounds__(kTreeBlock, 1) subgroup_tree_kernel(const uint4* __restrict__ points,
                                                                 const __grid_constant__ Parts parts,
                                                                 const uint8_t* __restrict__ dec_ok,
                                                                 uint8_t* __restrict__ sub_ok,
                                                                 int* __restrict__ flags, uint32_t n) {
  constexpr int kPointLanes = G * P;
  constexpr int kPoints = kTreeBlock / kPointLanes;
  static_assert(kPoints >= 1 && P >= 2 && kPointLanes >= 4, "whole points a block; group 1 forms beta X1; 4 cross products");
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x % kPointLanes, g = lane / G, r = lane % G;
  const uint32_t i = blockIdx.x * kPoints + threadIdx.x / kPointLanes;
  const bool live = i < n;
  const size_t at = min(i, n - 1);
  const unsigned mask = ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
  const unsigned point_mask =
      kPointLanes >= 32 ? ~0u : ((1u << kPointLanes) - 1) << (threadIdx.x % 32 / kPointLanes * kPointLanes);
  uint4* const slots = smem + (size_t)(threadIdx.x / kPointLanes) * (kTreeSlots * kVecs + P * kScratchVecs);
  uint4* const scratch = slots + kTreeSlots * kVecs + g * kScratchVecs;

#pragma unroll 1
  for (int k = g; k < 8; k += P)
    add_lanes_from<G>(slots + k * kVecs, [&](int c) { return part_coord(parts, k, at, c); },
                      [&](int c) { return part_coord(parts, k + 8, at, c); }, scratch, r, mask);
  level_sync<kPointLanes>(point_mask);
#pragma unroll 1
  for (int h = 4; h >= 1; h /= 2) {
#pragma unroll 1
    for (int k = g; k < h; k += P) add_lanes<G>(slots + k * kVecs, slots + (k + h) * kVecs, scratch, r, mask);
    level_sync<kPointLanes>(point_mask);
  }
  const uint4* p = points + at * kVecs;
  if (g == 0) {
    add_lanes_from<G>(slots, [&](int c) { return lds(slots + 3 * c); },
                      [&](int c) { return part_coord(parts, kParts - 1, at, c); }, scratch, r, mask);
  } else if (lane == G) {
    sts(slots + kVecs, mul(ldg(p), beta_mont()));
  }
  level_sync<kPointLanes>(point_mask);

  // phi(P) = (beta X1, Y1, Z1) against -[z^2]P = (X2, -Y2, Z2): the
  // point's lane 0 takes beta X1 Z2, lane 1 X2 Z1, lane 2 Y1 Z2, lane 3
  // -Y2 Z1, into group 0's scratch.
  uint4* const cross = slots + kTreeSlots * kVecs;
  if (lane < 4) {
    const Elt left = lane == 0 ? lds(slots + kVecs) : lane == 1 ? lds(slots) : lane == 2 ? ldg(p + 3) : sub(zero(), lds(slots + 3));
    sts(cross + 3 * lane, mul(left, lane == 0 || lane == 2 ? lds(slots + 6) : ldg(p + 6)));
  }
  level_sync<kPointLanes>(point_mask);
  bool in_group = true;
  if (lane == 0) {
    const bool eq_x = equal(lds(cross), lds(cross + 3));
    const bool eq_y = equal(lds(cross + 6), lds(cross + 9));
    const bool inf_a = is_zero(ldg(p + 6)), inf_b = is_zero(lds(slots + 6));
    in_group = (eq_x && eq_y && !inf_a && !inf_b) || (inf_a && inf_b);
    if (live) sub_ok[i] = in_group;
  }
  if (flags != nullptr) {
    const bool lead = live && lane == 0;
    if (!__syncthreads_and(!lead || in_group) && threadIdx.x == 0) flags[1] = 0;
    const bool decoded = !lead || dec_ok == nullptr || dec_ok[i] != 0;
    if (!__syncthreads_and(decoded) && threadIdx.x == 0) flags[0] = 0;
  }
}

bool aligned(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// The opt-in to more than 48 KB of dynamic shared memory is a function
// attribute of the current device's context: set at every launch, to what
// this one needs, as the chain launchers of field_kernels.cu do.
template <int T, int L>
int launch_decompress(const void* comp, void* out, void* ok, void* flags, long long n, const SqrtChain& ch,
                      cudaStream_t s) {
  const size_t smem = ((size_t)ch.entries * (Fp::N / L) + 6 * 4) * 4 * T;  // the table, then xm and rhs
  const cudaError_t opt_in =
      cudaFuncSetAttribute(decompress_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  decompress_kernel<T, L><<<(unsigned)((n * L + T - 1) / T), T, smem, s>>>(
      (const uint4*)comp, (uint4*)out, (uint8_t*)ok, (int*)flags, (uint32_t)n, ch);
  return (int)cudaGetLastError();
}

template <int L>
int launch_decompress_lanes(const void* comp, void* out, void* ok, void* flags, long long n,
                            const SqrtChain& ch, cudaStream_t s) {
  switch (block_threads(n * L)) {
    case 128: return launch_decompress<128, L>(comp, out, ok, flags, n, ch, s);
    case 64: return launch_decompress<64, L>(comp, out, ok, flags, n, ch, s);
    default: return launch_decompress<32, L>(comp, out, ok, flags, n, ch, s);
  }
}

template <int T>
int launch_subgroup(const void* points, const Parts& parts, const void* dec_ok, void* sub_ok, void* flags,
                    long long n, cudaStream_t s) {
  constexpr int kPoints = T / kLanes;
  const size_t smem = (size_t)kPoints * (kSlots * kVecs + kScratchVecs) * 16;
  const cudaError_t opt_in = cudaFuncSetAttribute(subgroup_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  subgroup_kernel<T><<<(unsigned)((n + kPoints - 1) / kPoints), T, smem, s>>>(
      (const uint4*)points, parts, (const uint8_t*)dec_ok, (uint8_t*)sub_ok, (int*)flags, (uint32_t)n);
  return (int)cudaGetLastError();
}

template <int G, int P>
int launch_subgroup_tree(const void* points, const Parts& parts, const void* dec_ok, void* sub_ok, void* flags,
                         long long n, cudaStream_t s) {
  constexpr int kPoints = kTreeBlock / (G * P);
  const size_t smem = (size_t)kPoints * (kTreeSlots * kVecs + P * kScratchVecs) * 16;  // under 48 KB: no opt-in
  subgroup_tree_kernel<G, P><<<(unsigned)((n + kPoints - 1) / kPoints), kTreeBlock, smem, s>>>(
      (const uint4*)points, parts, (const uint8_t*)dec_ok, (uint8_t*)sub_ok, (int*)flags, (uint32_t)n);
  return (int)cudaGetLastError();
}

bool bad_count(long long n) { return n < 1 || n >= (1LL << 29); }

}  // namespace

// Kernel A: comp [n, 48] uint8 -> points [n, 3, 12], ok [n] uint8; flags
// [2] int32 set to 1 when not null; `lanes` (1, 2 or 4) a point; the square
// root's chain as `chain_len` bytes (parse_chain).  The last chain checked
// on this host thread is kept, so a launch with the same bytes skips the
// check.
extern "C" int kzg_g1_decompress(const void* comp, void* points, void* ok, void* flags, long long n,
                                 long long lanes, const void* chain, long long chain_len, void* stream) {
  if (!aligned(comp) || !aligned(points) || bad_count(n) || chain_len > 1 + 2 * kChainMaxSteps)
    return (int)cudaErrorInvalidValue;
  static thread_local uint8_t last[1 + 2 * kChainMaxSteps];
  static thread_local long long last_len = 0;
  static thread_local SqrtChain ch;
  if (chain == nullptr || chain_len != last_len || memcmp(chain, last, (size_t)chain_len) != 0) {
    last_len = 0;
    if (!parse_chain((const uint8_t*)chain, chain_len, ch)) return (int)cudaErrorInvalidValue;
    memcpy(last, chain, (size_t)chain_len);
    last_len = chain_len;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_decompress_lanes<1>(comp, points, ok, flags, n, ch, s);
    case 2: return launch_decompress_lanes<2>(comp, points, ok, flags, n, ch, s);
    case 4: return launch_decompress_lanes<4>(comp, points, ok, flags, n, ch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel B: points [n, 3, 12]; bases and bases2 [66, n, 3, 12] whose rows
// lie row_stride 32-bit words apart (the even and odd rows of the K4 chain
// tensor, or any two such tables) -> sub_ok [n] uint8.  dec_ok [n] uint8
// and flags [2] int32 may be null (no flags then).  The variant: `lanes`
// an add and `groups` a point, (8, 8), (8, 4), (8, 2) or (2, 2) for the
// level-parallel tree, (4, 1) for the serial one.
extern "C" int kzg_g1_subgroup_check(const void* points, const void* bases, const void* bases2,
                                     long long row_stride, const void* dec_ok, void* sub_ok, void* flags,
                                     long long n, long long lanes, long long groups, void* stream) {
  if (!aligned(points) || !aligned(bases) || !aligned(bases2) || row_stride % 4 || bad_count(n))
    return (int)cudaErrorInvalidValue;
  Parts parts{};
  for (int j = 0, k = 0; j < kWindows; j++) {
    const int d = kZ2Digits[j];
    if (d == 0) continue;
    parts.row[k] = (const uint4*)(d == 2 || d == -2 ? bases2 : bases) + j * (row_stride / 4);
    if (d < 0) parts.neg |= 1u << k;
    k++;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || groups < 1 || groups > 99) return (int)cudaErrorInvalidValue;
  switch (lanes * 100 + groups) {
    case 401:
      switch (block_threads(kLanes * n)) {
        case 128: return launch_subgroup<128>(points, parts, dec_ok, sub_ok, flags, n, s);
        case 64: return launch_subgroup<64>(points, parts, dec_ok, sub_ok, flags, n, s);
        default: return launch_subgroup<32>(points, parts, dec_ok, sub_ok, flags, n, s);
      }
    case 808: return launch_subgroup_tree<8, 8>(points, parts, dec_ok, sub_ok, flags, n, s);
    case 804: return launch_subgroup_tree<8, 4>(points, parts, dec_ok, sub_ok, flags, n, s);
    case 802: return launch_subgroup_tree<8, 2>(points, parts, dec_ok, sub_ok, flags, n, s);
    case 202: return launch_subgroup_tree<2, 2>(points, parts, dec_ok, sub_ok, flags, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
