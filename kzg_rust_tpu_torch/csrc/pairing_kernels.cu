// The device pairing for Hopper (sm_90a): three kernels over csrc/tower.cuh,
// a lane group of G lanes for each pairing lane, check or element, its
// state in shared memory and each step's independent Fp products side by
// side over the group's lanes.
//
// P2 kzg_miller_loop replaces the JAX package's XLA program
// kzg_rust_tpu/ops/pairing.py:202 miller_loop_kernel: the batched
// inversion-free Miller loop, all 63 steps in one launch.  T is homogeneous
// projective over Fp2 with the exception-free RCB doubling and mixed add
// (b3 = 3 * 4 (1 + u) = 12 + 12u on the twist), and each line keeps the
// JAX package's scale, 2 Y Z^2 for a tangent and x2 Z - X for a chord
// (pairing.py:146-176), so f is the JAX program's value word for word,
// not only the final flag.  The bits of |x| are public and the same in
// every lane, so a step runs the program of its bit (a doubling step, or
// a doubling and addition step) where the JAX scan computes both outcomes
// and selects (pairing.py:215-220): the same function.  The value is
// conjugated at the end (x < 0); a lane with an infinity argument (active
// 0) yields one (pairing.py:225).
//
// P3 kzg_final_exp replaces the programs of the final exponentiation:
// _easy_part_kernel (:264), _exp_by_x_with_bits (:236), _mul_conj_kernel
// (:275), _mul_frob_kernel (:280) and _hard_tail_kernel (:294).  Per check
// it multiplies the two Miller values f[0, k] f[1, k], runs the easy part,
// the hard part's five exponentiations by x (a Granger-Scott squaring a
// bit, a product on each set bit of the bits it is given, MSB first below
// the implicit leading one; the real |x| or a small test exponent) and the
// tail, and writes the is-one flag, or under want_value the value before
// the test, so that a caller can compare values.
//
// P1 kzg_fp12_op replaces no TPU kernel: it runs one Fp12 function's
// program over [n] elements (the op codes below), for ops/tower.py's Fp12
// functions on the card, so that each program that the Miller steps and
// the final exponentiation compose is held against its plain version at
// width: a wrong Miller value can then be traced to its function.
//
// Bound: operations.  A Miller lane takes 124 Fp products a doubling step
// and 209 on the 5 steps with a set bit (8,237 over the 63 steps); a final
// exponentiation 7,020 in the exponentiations by x (5 x (63 x 18 + 5 x
// 54)), 281 in the easy part besides its Fermat chain (~470), 416 in the
// hard chain's parts and the tail.
//
// The design.  The first design of these kernels, one thread a lane, was
// latency-bound twice over: each lane's ~8.4k products ran one after
// another, with the 144-word Fp12 state going through local memory between
// the tower's calls (1.5 us a product), and 2 K lanes in blocks of 32 left
// most SMs idle.  Here each pairing lane (P2), check (P3) or element (P1)
// is a group of G = 8, 16 or 32 lanes of a warp (a block is one warp, 32 /
// G groups), with a frame of Fp slots in dynamic shared memory: P2's f, T,
// Q, P and scratch (194 slots, 9,312 bytes a group), P3's six Fp12 values
// and scratch (266 slots, 12,768 bytes) and its Fermat table, P1's
// operands, result and scratch (182 slots).  Every function is a program
// of levels (pairing_programs.cuh, which ops/_build.py generates from
// kzg_rust_tpu_torch/ops/pairing_programs.py into the build directory
// before it compiles): a level of products runs
// its independent Fp products side by side, lane j taking products j, j +
// G, ...; the linear work between products runs as sums of three terms, in
// as few levels as its chains need, and the levels of a chain that no
// product needs soon wait for the next gap; the group syncs between
// levels.  Within a Miller step the tangent's and the doubling's products
// share f's squaring's level (each small multiple of the RCB formulas
// moved onto an operand, so that it is formed before that level), and the
// chord's and the mixed add's products the levels around the first line
// product.  Level counts (products / linear levels; python -m
// kzg_rust_tpu_torch.ops.pairing_programs lists them all):
//   doubling step           3 (58, 24, 42) / 14      against 126 dependent
//   step with a set bit     5 (58, 24, 57, 28, 42) / 21    products before
//   Granger-Scott squaring  1 (18) / 5
//   product by the base     1 (54) / 6
//   easy part               11 and the inversion / 38
// P3's squarings and products by the base go from ACC into ALT and back,
// so that no step overwrites its operand (no copy level).  The easy part's
// inversion comes down by norms to one Fp inversion, a^(p-2) by K1's chain
// over 4 lanes with kernel A's lane product (faster on the card than the
// chain on one lane at every K swept, PERF.md).  Each product runs in
// registers by field.cuh's inlined cios_mul; no value goes through local
// memory.  G is the launch's (ops/tower.py pairing_group, from the card's
// sweep in chip_smoke.py phase 3h).

#include "tower.cuh"

namespace kzg {
namespace {

// |x| for BLS12-381, x = -0xd201000000010000 (golden/field.py BLS_X); the
// Miller loop runs over its bits below the MSB, MSB first.
constexpr unsigned long long kAbsX = 0xd201000000010000ull;
constexpr int kAbsXBits = 64;

enum Fp12Op { kOpMul = 0, kOpSqr = 1, kOpCycloSqr = 2, kOpFrobenius = 3, kOpInv = 4, kOpMulByLine = 5 };

// P3's program sequence (ops/pairing_programs.py p3_sequence), built on the
// host from the exponent's bits: a kernel parameter, read at one address
// by every lane.
constexpr int kMaxSeq = 1 + 5 * (2 * kAbsXBits + 2) + 3;
struct Seq {
  uint8_t prog[kMaxSeq];
  uint32_t count;
};

// Bytes of dynamic shared memory a block: 32 / G frames of `slots` slots,
// then the Fermat table (15 x 12 / kInvLanes words a thread).
template <int G>
constexpr size_t block_smem(int slots, bool table) {
  const size_t frames = (size_t)(kWarp / G) * slots * kSlotWords * 4;
  return frames + (table ? (size_t)kInvTop * (12 / kInvLanes) * kWarp * 4 : 0);
}

// The group of this thread: its frame and table in the block's shared
// memory.
template <int G>
__device__ __forceinline__ Group make_group(uint32_t* smem, int slots, bool table) {
  Group g;
  const int gi = threadIdx.x / G;
  g.lane = threadIdx.x % G;
  g.mask = group_mask<G>(gi);
  g.frame = smem + (size_t)gi * slots * kSlotWords;
  uint32_t* tables = smem + (size_t)(kWarp / G) * slots * kSlotWords;
  g.table = table ? tables + threadIdx.x : nullptr;
  return g;
}

// Slot `slot` of the frame = one (value 1) or zero (0), over the lanes.
__device__ __forceinline__ void put_small(const Group& g, int slot, bool one) {
  uint32_t v[12];
#pragma unroll
  for (int j = 0; j < 12; j++) v[j] = one ? kOneMont.w[j] : 0u;
  slot_store(g.frame, slot, v);
}

// f_{|x|,Q}(P) conjugated, a group a lane: n = pairs x checks lanes.
template <int G>
__global__ void __launch_bounds__(kWarp, 16)
    miller_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, const uint32_t* __restrict__ qx,
                  const uint32_t* __restrict__ qy, const uint8_t* __restrict__ active, uint32_t* __restrict__ out,
                  uint32_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Group g = make_group<G>(smem, kP2Slots, false);
  const uint32_t i = blockIdx.x * (kWarp / G) + threadIdx.x / G;
  if (i >= n) return;
  const bool on = active[i] != 0;
  if (on) {
    load_consts<G>(g, kP2ConstFirst, kP2ConstBase, kP2Consts);
    // F = 1, T = (x2, y2, 1), Q = (x2, y2), P = (xp, yp).
    for (int e = g.lane; e < 12; e += G) put_small(g, kP2RegF + e, e == 0);
    load_slots<G>(g, kP2RegT, qx + 24 * (size_t)i, 2);
    load_slots<G>(g, kP2RegT + 2, qy + 24 * (size_t)i, 2);
    for (int e = g.lane; e < 2; e += G) put_small(g, kP2RegT + 4 + e, e == 0);
    load_slots<G>(g, kP2RegQ, qx + 24 * (size_t)i, 2);
    load_slots<G>(g, kP2RegQ + 2, qy + 24 * (size_t)i, 2);
    load_slots<G>(g, kP2RegP, xp + 12 * (size_t)i, 1);
    load_slots<G>(g, kP2RegP + 1, yp + 12 * (size_t)i, 1);
    __syncwarp(g.mask);
#pragma unroll 1
    for (int b = kAbsXBits - 2; b >= 0; b--) run_program<G>(g, (kAbsX >> b) & 1ull ? kP2DblAdd : kP2Dbl);
  }
  // conj(f), or one for an inactive lane.
  for (int e = g.lane; e < 12; e += G) {
    uint32_t v[12];
    if (on) {
      slot_load(v, g.frame, kP2RegF + e);
      if (e >= 6) {
        const uint32_t zero[12] = {};
        uint32_t w[12];
        fp_sub(w, zero, v);  // fp_sub writes its output before it reads b
#pragma unroll
        for (int j = 0; j < 12; j++) v[j] = w[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 12; j++) v[j] = e == 0 ? kOneMont.w[j] : 0u;
    }
    store_vec<12>(reinterpret_cast<uint4*>(out + 144 * (size_t)i + 12 * e), v);
  }
}

// The final exponentiation of f[0, i] f[1, i] (k checks), a group a check:
// the is-one flag, or the value under want_value.  A group past k runs
// check k - 1 and stores nothing, so that every warp's shuffles are whole.
template <int G>
__global__ void __launch_bounds__(kWarp, 16)
    final_exp_kernel(const uint32_t* __restrict__ f, void* __restrict__ out, uint32_t k,
                     const __grid_constant__ Seq seq, int want_value) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Group g = make_group<G>(smem, kP3Slots, true);
  const uint32_t i0 = blockIdx.x * (kWarp / G) + threadIdx.x / G, i = i0 < k ? i0 : k - 1;
  load_consts<G>(g, kP3ConstFirst, kP3ConstBase, kP3Consts);
  load_slots<G>(g, kP3RegU, f + 144 * (size_t)i, 12);
  load_slots<G>(g, kP3RegW1, f + 144 * ((size_t)k + i), 12);
  __syncwarp(g.mask);
#pragma unroll 1
  for (uint32_t s = 0; s < seq.count; s++) run_program<G>(g, seq.prog[s]);
  if (want_value) {
    if (i0 < k)
      for (int e = g.lane; e < 12; e += G) {
        uint32_t v[12];
        slot_load(v, g.frame, kP3RegU + e);
        store_vec<12>(reinterpret_cast<uint4*>((uint32_t*)out + 144 * (size_t)i0 + 12 * e), v);
      }
    return;
  }
  bool one = true;
  for (int e = g.lane; e < 12; e += G) {
    uint32_t v[12];
    slot_load(v, g.frame, kP3RegU + e);
#pragma unroll
    for (int j = 0; j < 12; j++) one = one && v[j] == (e == 0 ? kOneMont.w[j] : 0u);
  }
  one = __all_sync(g.mask, one);
  if (i0 < k && g.lane == 0) ((uint8_t*)out)[i0] = one ? 1 : 0;
}

// One Fp12 function over n elements: a [n] Fp12, b [n] Fp12 (mul) or [n]
// line coefficients (c00, c11, c12) (mul_by_line), out [n] Fp12.  A group
// past n runs element n - 1 and stores nothing.
template <int G>
__global__ void __launch_bounds__(kWarp, 16)
    tower_op_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                    uint32_t n, int op) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Group g = make_group<G>(smem, kP1Slots, op == kOpInv);
  const uint32_t i0 = blockIdx.x * (kWarp / G) + threadIdx.x / G, i = i0 < n ? i0 : n - 1;
  load_consts<G>(g, kP1ConstFirst, kP1ConstBase, kP1Consts);
  load_slots<G>(g, kP1RegA, a + 144 * (size_t)i, 12);
  if (op == kOpMul) load_slots<G>(g, kP1RegB, b + 144 * (size_t)i, 12);
  if (op == kOpMulByLine) load_slots<G>(g, kP1RegB, b + 72 * (size_t)i, 6);
  __syncwarp(g.mask);
  run_program<G>(g, kP1Mul + op);
  if (i0 < n)
    for (int e = g.lane; e < 12; e += G) {
      uint32_t v[12];
      slot_load(v, g.frame, kP1RegZ + e);
      store_vec<12>(reinterpret_cast<uint4*>(out + 144 * (size_t)i0 + 12 * e), v);
    }
}

// P3's program sequence for the exponent's bits (ops/pairing_programs.py
// p3_sequence): each exponentiation's squarings and products run from ACC
// into ALT and back; false for more than 64 bits or a bit other than 0 or
// 1.
bool make_seq(const uint8_t* bits, long long nbits, Seq& seq) {
  seq = Seq{};
  if (nbits < 0 || nbits > kAbsXBits) return false;
  const uint8_t between[5] = {kP3Hard1, kP3Hard2, kP3Hard3, kP3Hard4, kP3Tail1};
  seq.prog[seq.count++] = kP3Easy;
  for (int r = 0; r < 5; r++) {
    bool in_alt = false;
    for (long long j = 0; j < nbits; j++) {
      if (bits[j] > 1) return false;
      for (int m = 0; m <= bits[j]; m++) {
        seq.prog[seq.count++] = m ? (in_alt ? kP3MulAlt : kP3Mul) : (in_alt ? kP3SqrAlt : kP3Sqr);
        in_alt = !in_alt;
      }
    }
    if (in_alt) seq.prog[seq.count++] = kP3Alt;
    seq.prog[seq.count++] = between[r];
  }
  seq.prog[seq.count++] = kP3Tail2;
  seq.prog[seq.count++] = kP3Tail3;
  seq.prog[seq.count++] = kP3Tail4;
  return true;
}

// Launchers: blocks of one warp, 32 / G groups a block.  A block's shared
// memory (past 48 KB for P3 at G = 8) is set as the kernel's limit before
// every launch: the attribute belongs to the current device, and the call
// is cheap.
inline unsigned blocks_for(long long n, int g) { return (unsigned)((n + kWarp / g - 1) / (kWarp / g)); }

template <int G>
int launch_miller(const void* xp, const void* yp, const void* qx, const void* qy, const void* active, void* out,
                  long long n, cudaStream_t s) {
  const size_t smem = block_smem<G>(kP2Slots, false);
  auto kernel = miller_kernel<G>;
  if (const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)e;
  kernel<<<blocks_for(n, G), kWarp, smem, s>>>((const uint32_t*)xp, (const uint32_t*)yp, (const uint32_t*)qx,
                                                (const uint32_t*)qy, (const uint8_t*)active, (uint32_t*)out,
                                                (uint32_t)n);
  return (int)cudaGetLastError();
}

template <int G>
int launch_final_exp(const void* f, void* out, long long k, const Seq& seq, int want_value, cudaStream_t s) {
  const size_t smem = block_smem<G>(kP3Slots, true);
  auto kernel = final_exp_kernel<G>;
  if (const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)e;
  kernel<<<blocks_for(k, G), kWarp, smem, s>>>((const uint32_t*)f, out, (uint32_t)k, seq, want_value);
  return (int)cudaGetLastError();
}

template <int G>
int launch_op(const void* a, const void* b, void* out, long long n, int op, cudaStream_t s) {
  const size_t smem = block_smem<G>(kP1Slots, true);
  auto kernel = tower_op_kernel<G>;
  if (const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)e;
  kernel<<<blocks_for(n, G), kWarp, smem, s>>>((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (uint32_t)n, op);
  return (int)cudaGetLastError();
}

bool valid_group(int group) { return group == 8 || group == 16 || group == 32; }

}  // namespace
}  // namespace kzg

using namespace kzg;

#define KZG_BY_GROUP(G_, CALL)                        \
  switch (G_) {                                       \
    case 8: return CALL(8);                           \
    case 16: return CALL(16);                         \
    case 32: return CALL(32);                         \
    default: return (int)cudaErrorInvalidValue;       \
  }

extern "C" int kzg_fp12_op(const void* a, const void* b, void* out, long long n, int op, int group, void* stream) {
  if (op < kOpMul || op > kOpMulByLine || n < 1 || n >= (1ll << 31) || !valid_group(group))
    return (int)cudaErrorInvalidValue;
#define KZG_OP(G) launch_op<G>(a, b, out, n, op, (cudaStream_t)stream)
  KZG_BY_GROUP(group, KZG_OP)
#undef KZG_OP
}

extern "C" int kzg_miller_loop(const void* xp, const void* yp, const void* qx, const void* qy,
                               const void* active, void* out, long long n, int group, void* stream) {
  if (n < 1 || n >= (1ll << 31) || !valid_group(group)) return (int)cudaErrorInvalidValue;
#define KZG_ML(G) launch_miller<G>(xp, yp, qx, qy, active, out, n, (cudaStream_t)stream)
  KZG_BY_GROUP(group, KZG_ML)
#undef KZG_ML
}

extern "C" int kzg_final_exp(const void* f, void* out, long long k, const void* bits, long long nbits,
                             int want_value, int group, void* stream) {
  Seq seq;
  if (k < 1 || k >= (1ll << 31) || !valid_group(group) || !make_seq((const uint8_t*)bits, nbits, seq))
    return (int)cudaErrorInvalidValue;
#define KZG_FE(G) launch_final_exp<G>(f, out, k, seq, want_value, (cudaStream_t)stream)
  KZG_BY_GROUP(group, KZG_FE)
#undef KZG_FE
}
