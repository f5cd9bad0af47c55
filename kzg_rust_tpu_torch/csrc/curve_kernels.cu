// G1 kernels for Hopper (sm_90a): the complete projective add (K3) and
// doubling (K4) of Renes, Costello and Batina (eprint 2015/1060, algorithms
// 7 and 9, a = 0, b3 = 3 b = 12) over homogeneous projective (X, Y, Z) in
// Montgomery form; the point at infinity is (0, mont(1), 0).
//
// K3 replaces kzg_rust_tpu/ops/pallas_kernels.py:348 proj_add_pallas and K4
// replaces :354 proj_double_pallas (factory _make_proj_op :262).  K4 also
// runs as a chain, out[k] = 2^(k+1) P for k < steps, in one launch: the
// window-base chain of stage 1 (2W - 1 = 131 doublings), which the JAX
// package runs as one lax.scan (kzg_rust_tpu/ops/verify_kernels.py:122).
//
// What bounds them on this card.  An add is 12 Fp Montgomery products and a
// doubling 8 (the products by b3 = 12 of curve.py are four adds here, which
// give the same canonical value); each product is ~600 32-bit multiply-adds against
// 432 or 288 bytes of traffic per point, so at the wide levels of the path
// (K3 over 65,536 to 1,081,344 point pairs) the integer multiply-add pipe is
// the bound.  At the narrow levels (K3's upper tree levels, the chain over
// 128 or 8,192 points: one warp or less per SM sub-partition) the bound is
// latency: the dependent carry chains of one product, and for the chain
// 131 doublings in sequence.
//
// What the design does about it.
// - The products run on PTX carry chains and wide multiplies (field.cuh
//   fp_mont_mul): 902 instructions a product against the 1,113 of the
//   first core's 64-bit C arithmetic.
// - K3 stages its block's operands and results through shared memory with
//   coalesced 16-byte accesses (a point is 144 B = 9 x 16 B, and each
//   thread's 16-byte shared loads hit distinct banks, 9 being odd).  The
//   operands stay in shared memory and are reloaded where the formula uses
//   them, and temporaries wait there for their last use once a coordinate
//   is spent, so that at most four 12-word values are live in registers
//   beside a product: under 128 registers at 128 threads, 4 blocks (16
//   warps) per SM, with no spills.
// - Both kernels choose their block size from n (128, 64 or 32 threads), so
//   that a narrow launch still spreads over the SMs.
// - The chain keeps the point in registers from one doubling to the next and
//   writes each step with 16-byte stores: one launch instead of 131, so the
//   host enqueues one call and the card runs the steps back to back.  Four
//   lanes share each point and split the doubling's independent products,
//   so a step waits for two products in a row, not eight, and a narrow
//   chain occupies four times as many warps.
// - The tensor cores and TMA are not used.  The operands are 12-word
//   integers that differ for every point, so no tile is shared across rows
//   for a matrix product to reuse; and a block moves a few kilobytes once,
//   which coalesced 16-byte loads already do at full rate.
//
// Every output coordinate is the canonical Montgomery integer of the same
// formula as curve.py (proj_add :122, proj_double :184), hence the same
// words as the JAX package's: canonical arithmetic gives one value whatever
// the evaluation order, and its lazy-reduction adds only feed products.
//
// Points are [n, 3, 12] 32-bit words, contiguous, 16-byte aligned (the
// entry points return cudaErrorInvalidValue otherwise).  C interface as in
// field_kernels.cu: launch on the given stream, return cudaGetLastError().

#include <cuda_runtime.h>

#include "curve.cuh"

using namespace kzg;

namespace {

constexpr int N = Fp::N;
constexpr int kVecs = 9;  // 16-byte vectors per point; 3 per coordinate

// K3.  Thread t adds point pair t of the block's tile (curve.cuh
// add_staged: P's tile slot gets the sum, Q's holds temporaries); the block
// then copies the tile of results out of the P slots.
template <int T>
__global__ void __launch_bounds__(T, 512 / T) proj_add_kernel(
    const uint4* __restrict__ p, const uint4* __restrict__ q, uint4* __restrict__ out,
    uint32_t n) {
  __shared__ uint4 tp[T * kVecs];
  __shared__ uint4 tq[T * kVecs];
  const size_t first = (size_t)blockIdx.x * T;
  const uint32_t m = min((uint32_t)T, n - (uint32_t)first);
  p += first * kVecs;
  q += first * kVecs;
  for (uint32_t k = threadIdx.x; k < m * kVecs; k += T) {
    tp[k] = __ldg(p + k);
    tq[k] = __ldg(q + k);
  }
  __syncthreads();
  if (threadIdx.x < m) add_staged(tp + threadIdx.x * kVecs, tq + threadIdx.x * kVecs);
  __syncthreads();
  out += first * kVecs;
  for (uint32_t k = threadIdx.x; k < m * kVecs; k += T) out[k] = tp[k];
}

// Element v of lane `src` of this thread's group of four lanes.
__device__ __forceinline__ Elt from_lane(const Elt& v, int src) {
  Elt r;
#pragma unroll
  for (int j = 0; j < N; j++) r.w[j] = __shfl_sync(0xffffffffu, v.w[j], src, 4);
  return r;
}

// One doubling by a group of four lanes, each holding the whole point (RCB
// algorithm 9; the same values as curve.py's order).  The formula's nine
// products fall into two levels of dependence, Y^2, YZ, Z^2, XY and then
// four more, with b3 Z^2 (adds) between them.  Lane `role` takes one product
// of each level, every lane does the adds, and shuffles exchange the
// products, so a step waits for two products instead of eight.
__device__ __forceinline__ void dbl4(Elt& x, Elt& y, Elt& z, uint32_t role) {
  const Elt u = mul(sel(role == 2, z, sel(role == 3, x, y)), sel(role == 0 || role == 3, y, z));
  const Elt t0 = from_lane(u, 0);              // Y^2
  const Elt t2 = times_b3(from_lane(u, 2));    // b3 Z^2
  Elt z3 = add(t0, t0);
  z3 = add(z3, z3);
  z3 = add(z3, z3);                            // 8 Y^2
  const Elt y3 = add(t0, t2);
  const Elt t0m = sub(t0, add(add(t2, t2), t2));  // Y^2 - 3 b3 Z^2
  // Lane 0: b3 Z^2 * 8 Y^2, lane 1: YZ * 8 Y^2 (= Z3), lane 2: t0m * y3,
  // lane 3: t0m * XY.
  const Elt v = mul(sel(role == 0, t2, sel(role == 1, u, t0m)), sel(role <= 1, z3, sel(role == 2, y3, u)));
  const Elt w = from_lane(v, 3);
  x = add(w, w);
  y = add(from_lane(v, 0), from_lane(v, 2));
  z = from_lane(v, 1);
}

// K4 as a chain: out[k] = 2^(k+1) P, each step [n, 3, 12] after the last,
// four lanes per point.  The point stays in registers between steps; each
// lane stores every fourth 16-byte vector of it.  steps = 1 is K4 alone.
// A group past the last point doubles a copy of it (the shuffles need every
// lane of the warp) and stores nothing.
template <int T>
__global__ void __launch_bounds__(T) proj_double_chain_kernel(
    const uint4* __restrict__ p, uint4* __restrict__ out, uint32_t n, uint32_t steps) {
  const uint32_t i = (blockIdx.x * T + threadIdx.x) >> 2;
  const uint32_t role = threadIdx.x & 3;
  const bool live = i < n;
  p += (size_t)(live ? i : n - 1) * kVecs;
  Elt x = ldg(p), y = ldg(p + 3), z = ldg(p + 6);
  uint4* o = out + (size_t)i * kVecs;
  for (uint32_t k = 0; k < steps; k++, o += (size_t)n * kVecs) {
    dbl4(x, y, z, role);
    if (!live) continue;
#pragma unroll
    for (int v = 0; v < kVecs; v++) {
      if ((v & 3) != (int)role) continue;
      const Elt& e = v < 3 ? x : (v < 6 ? y : z);
      const int w = 4 * (v % 3);
      o[v] = make_uint4(e.w[w], e.w[w + 1], e.w[w + 2], e.w[w + 3]);
    }
  }
}

bool aligned(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <int T>
void launch_add(const void* p, const void* q, void* out, long long n, cudaStream_t s) {
  proj_add_kernel<T><<<(unsigned)((n + T - 1) / T), T, 0, s>>>(
      (const uint4*)p, (const uint4*)q, (uint4*)out, (uint32_t)n);
}

template <int T>
void launch_chain(const void* p, void* out, long long n, long long steps, cudaStream_t s) {
  proj_double_chain_kernel<T><<<(unsigned)((4 * n + T - 1) / T), T, 0, s>>>(
      (const uint4*)p, (uint4*)out, (uint32_t)n, (uint32_t)steps);
}

}  // namespace

extern "C" int kzg_proj_add(const void* p, const void* q, void* out, long long n,
                            void* stream) {  // K3
  if (!aligned(p) || !aligned(q) || !aligned(out)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block_threads(n)) {
    case 128: launch_add<128>(p, q, out, n, s); break;
    case 64: launch_add<64>(p, q, out, n, s); break;
    default: launch_add<32>(p, q, out, n, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_proj_double_chain(const void* p, void* out, long long n, long long steps,
                                     void* stream) {  // K4, steps doublings in one launch
  if (!aligned(p) || !aligned(out)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block_threads(4 * n)) {
    case 128: launch_chain<128>(p, out, n, steps, s); break;
    case 64: launch_chain<64>(p, out, n, steps, s); break;
    default: launch_chain<32>(p, out, n, steps, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int kzg_proj_double(const void* p, void* out, long long n, void* stream) {  // K4
  return kzg_proj_double_chain(p, out, n, 1, stream);
}
