// The extension tower Fp2 -> Fp6 -> Fp12 for Hopper (sm_90a) as programs
// over a lane group: the interpreter that the pairing kernels
// (pairing_kernels.cu) run, on csrc/field.cuh's Fp product, add and sub.
//
// A lane group of G lanes (G = 8, 16 or 32, aligned in its warp) owns a
// frame of Fp slots in shared memory, 12 words (48 bytes) a slot: the
// kernel's registers (its Fp12 values, the G2 point, the pairing's
// inputs), the constants, and scratch.  A program (pairing_programs.cuh,
// which ops/_build.py generates into the build directory by
// kzg_rust_tpu_torch/ops/pairing_programs.py from the
// formulas of the JAX package's ops/tower.py and ops/pairing.py) is a
// range of levels; a level is a set of independent Fp operations on
// slots: Montgomery products, linear sums a +- b +- c, or one Fermat
// inversion.  Lane j of a group takes operations j, j + G, ... of a level:
// it loads the operands from the frame into registers, runs the product
// (field.cuh cios_mul, inlined) or the adds, and stores the result; then
// the group syncs (__syncwarp over its lanes) before the next level.  So a
// Fp12 product's 54 independent Fp products run side by side over the
// group's lanes, and the state lives in shared memory, never in local
// memory.  An inversion level runs a^(p-2) by K1's fixed-window chain
// (kInvDigits) over kInvLanes = 4 lanes a copy with kernel A's lane
// product (field.cuh lane_mul: values below 2p, reduced once at the end);
// every lane of the warp must run it (its shuffles name the whole warp).
// Every value is canonical Montgomery (R = 2^384), so each
// program gives the words of the plain PyTorch version of the same
// function.

#pragma once

#include "field.cuh"
#include "pairing_programs.cuh"

namespace kzg {

struct Fe {
  uint32_t w[12];
};

// Montgomery constants (checked against golden/field.py by the CPU tests,
// which parse this file): 1, for the kernels' initial values.
__constant__ Fe kOneMont = {{0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,
                             0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,
                             0xfa80e493u, 0x15f65ec3u}};

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
constexpr int kInvLanes = 4;  // lanes of one Fermat inversion

constexpr int kSlotWords = 12;
constexpr int kWarp = 32;  // threads a block: a block is one warp of 32 / G groups

// Level codes of pairing_programs.cuh (2, the rest: an inversion).
constexpr uint32_t kCodeMul = 0, kCodeLin = 1;

// The lanes of group g of G lanes in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask(int g) {
  if constexpr (G == 32)
    return 0xffffffffu;
  else
    return ((1u << G) - 1u) << (G * (g % (32 / G)));
}

__device__ __forceinline__ void slot_load(uint32_t* v, const uint32_t* frame, uint32_t slot) {
  const uint4* p = reinterpret_cast<const uint4*>(frame + slot * kSlotWords);
#pragma unroll
  for (int k = 0; k < 3; k++) {
    const uint4 x = p[k];
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
}

__device__ __forceinline__ void slot_store(uint32_t* frame, uint32_t slot, const uint32_t* v) {
  uint4* p = reinterpret_cast<uint4*>(frame + slot * kSlotWords);
#pragma unroll
  for (int k = 0; k < 3; k++) p[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// An operation is two words of kOps: x = code << 30 | b << 20 | a << 10 |
// dst, y = sc << 11 | sb << 10 | c, over slots of the group's frame.

// A product: frame[dst] = frame[a] * frame[b].
__device__ __forceinline__ void op_mul(uint32_t* frame, uint2 op) {
  uint32_t a[12], b[12];
  slot_load(a, frame, (op.x >> 10) & 1023u);
  slot_load(b, frame, (op.x >> 20) & 1023u);
  fp_mont_mul(a, a, b);
  slot_store(frame, op.x & 1023u, a);
}

// A linear op: frame[dst] = frame[a] +- frame[b] +- frame[c].
__device__ __forceinline__ void op_lin(uint32_t* frame, uint2 op) {
  uint32_t a[12], b[12];
  slot_load(a, frame, (op.x >> 10) & 1023u);
  slot_load(b, frame, (op.x >> 20) & 1023u);
  if ((op.y >> 10) & 1u)
    fp_sub(a, a, b);
  else
    fp_add(a, a, b);
  slot_load(b, frame, op.y & 1023u);
  if ((op.y >> 11) & 1u)
    fp_sub(a, a, b);
  else
    fp_add(a, a, b);
  slot_store(frame, op.x & 1023u, a);
}

// y = x^(p-2) over the L lanes of this lane's aligned subgroup (lane r of
// it holds W = 12 / L words of each value): kInvDigits's chain, the table
// in this thread's column col of the block's table ([entry][word of the
// part][thread], kWarp threads), every product lane_mul's (values below
// 2p), the result gathered and reduced once.  x whole in every lane; y
// whole in every lane.  Every lane of the warp runs it.
template <int L>
__device__ __forceinline__ void inv_lanes(uint32_t* y, const uint32_t* x, uint32_t* col, int r) {
  constexpr int W = Fp::N / L;
  uint32_t m[W], acc[W], whole[Fp::N];
  uint32_t p[Fp::N];
#pragma unroll
  for (int j = 0; j < Fp::N; j++) p[j] = fp_mod_word(j);
  lane_part<L>(m, p, r);
  lane_part<L>(acc, x, r);
  table_put<W, kWarp>(col, 1, acc);
#pragma unroll 1
  for (uint32_t k = 2; k <= kInvDigits.top; k++) {
    lane_mul<L>(acc, acc, x, m, r);
    table_put<W, kWarp>(col, k, acc);
  }
  table_get<W, kWarp>(acc, col, kInvDigits.d[0]);
#pragma unroll 1
  for (uint32_t k = 1; k < kInvDigits.count; k++) {
#pragma unroll 1
    for (int s = 0; s < 4; s++) {
      lane_gather<L>(whole, acc);
      lane_mul<L>(acc, acc, whole, m, r);
    }
    const uint32_t d = kInvDigits.d[k];
    if (d) {
      uint32_t e[W];
      table_get<W, kWarp>(e, col, d);
      lane_gather<L>(whole, acc);
      lane_mul<L>(acc, e, whole, m, r);
    }
  }
  lane_gather<L>(y, acc);
  fp_reduce_once(y, y);
}

// The group's lanes and where its inversion table lies.
struct Group {
  uint32_t* frame;  // the group's frame (16-byte aligned)
  uint32_t* table;  // this thread's column of the block's inversion table
  int lane;         // lane in the group
  unsigned mask;    // the group's lanes in the warp
};

// An inversion level: frame[dst] = frame[a]^(p-2).
__device__ __forceinline__ void op_inv(const Group& g, uint2 op) {
  uint32_t x[12];
  slot_load(x, g.frame, (op.x >> 10) & 1023u);
  inv_lanes<kInvLanes>(x, x, g.table, g.lane % kInvLanes);
  if (g.lane == 0) slot_store(g.frame, op.x & 1023u, x);
}

// Run program prog over the group: its levels in order, a sync after each.
template <int G>
__device__ __forceinline__ void run_program(const Group& g, int prog) {
  const uint32_t first = kProgramLevel[prog], last = kProgramLevel[prog + 1];
#pragma unroll 1
  for (uint32_t l = first; l < last; l++) {
    const uint32_t lv = kLevels[l], begin = lv >> 2, end = kLevels[l + 1] >> 2, kind = lv & 3u;
    if (kind == kCodeMul) {
#pragma unroll 1
      for (uint32_t i = begin + g.lane; i < end; i += G) op_mul(g.frame, __ldg(kOps + i));
    } else if (kind == kCodeLin) {
#pragma unroll 1
      for (uint32_t i = begin + g.lane; i < end; i += G) op_lin(g.frame, __ldg(kOps + i));
    } else {
      op_inv(g, __ldg(kOps + begin));
    }
    __syncwarp(g.mask);
  }
}

// The constants of a kernel's frame (kConstWords from entry first) into
// slots base.. base + count - 1, over the group's lanes.
template <int G>
__device__ __forceinline__ void load_consts(const Group& g, int first, int base, int count) {
  for (int c = g.lane; c < count; c += G) {
    uint32_t v[12];
#pragma unroll
    for (int j = 0; j < 12; j++) v[j] = kConstWords[(first + c) * 12 + j];
    slot_store(g.frame, base + c, v);
  }
}

// Slots [slot, slot + n) of the frame from n consecutive Fp elements at src
// (global memory), over the group's lanes; and back.
template <int G>
__device__ __forceinline__ void load_slots(const Group& g, int slot, const uint32_t* __restrict__ src, int n) {
  for (int e = g.lane; e < n; e += G) {
    uint32_t v[12];
    load_vec<12>(v, reinterpret_cast<const uint4*>(src + 12 * e));
    slot_store(g.frame, slot + e, v);
  }
}

}  // namespace kzg
