// G1 kernels for Hopper (sm_90a): the complete projective add (K3) and
// doubling (K4) of Renes, Costello and Batina (eprint 2015/1060, algorithms
// 7 and 9, a = 0, b3 = 3 b = 12) over homogeneous projective (X, Y, Z) in
// Montgomery form; the point at infinity is (0, mont(1), 0).
//
// K3 replaces kzg_rust_tpu/ops/pallas_kernels.py:348 proj_add_pallas and K4
// replaces :354 proj_double_pallas (factory _make_proj_op :262).  What bounds
// them here: integer multiply-adds.  An add is 14 Fp Montgomery products
// (two by b3) and a doubling 9, 312 word products each, against 432 or 288
// bytes of traffic per point, so both are compute-bound by a wide margin.
// The design keeps one point pair per thread with every coordinate and
// temporary in registers and the whole formula in one residency (no
// intermediate ever reaches device memory), which is what the fused Pallas
// kernel did in VMEM.  The operation order is curve.py's (proj_add :122,
// proj_double :184), so every output coordinate is the same canonical
// Montgomery integer as the JAX package's; its lazy-reduction adds, which
// only feed products, become canonical adds here, which leave the products
// unchanged.
//
// Points are [n, 3, 12] 32-bit words, contiguous.  C interface as in
// field_kernels.cu: launch on the given stream, return cudaGetLastError().

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 128;
constexpr int N = Fp::N;

struct Elt {
  uint32_t w[N];
};

__device__ __forceinline__ Elt mul(const Elt& a, const Elt& b) {
  Elt r;
  mont_mul<Fp>(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Elt add(const Elt& a, const Elt& b) {
  Elt r;
  add_mod<Fp>(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Elt sub(const Elt& a, const Elt& b) {
  Elt r;
  sub_mod<Fp>(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Elt b3() {
  Elt r;
#pragma unroll
  for (int j = 0; j < N; j++) r.w[j] = FP_B3_MONT[j];
  return r;
}

__device__ __forceinline__ Elt load(const uint32_t* __restrict__ p) {
  Elt r;
  load_words<N>(r.w, p);
  return r;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ p, const Elt& v) {
  store_words<N>(p, v.w);
}

__global__ void __launch_bounds__(kThreads) proj_add_kernel(
    const uint32_t* __restrict__ p, const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
    uint32_t n) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t* pp = p + (size_t)i * 3 * N;
  const uint32_t* qq = q + (size_t)i * 3 * N;
  const Elt x1 = load(pp), y1 = load(pp + N), z1 = load(pp + 2 * N);
  const Elt x2 = load(qq), y2 = load(qq + N), z2 = load(qq + 2 * N);

  const Elt t0 = mul(x1, x2);
  const Elt t1 = mul(y1, y2);
  const Elt t2 = mul(z1, z2);
  const Elt t3 = sub(mul(add(x1, y1), add(x2, y2)), add(t0, t1));  // X1Y2 + X2Y1
  const Elt t4 = sub(mul(add(y1, z1), add(y2, z2)), add(t1, t2));  // Y1Z2 + Y2Z1
  const Elt t5 = sub(mul(add(x1, z1), add(x2, z2)), add(t0, t2));  // X1Z2 + X2Z1
  const Elt three_t0 = add(add(t0, t0), t0);
  const Elt bt2 = mul(b3(), t2);
  const Elt z3t = add(t1, bt2);
  const Elt t1m = sub(t1, bt2);
  const Elt y3t = mul(b3(), t5);
  const Elt x3 = sub(mul(t3, t1m), mul(t4, y3t));
  const Elt y3 = add(mul(y3t, three_t0), mul(t1m, z3t));
  const Elt z3 = add(mul(z3t, t4), mul(three_t0, t3));

  uint32_t* o = out + (size_t)i * 3 * N;
  store(o, x3);
  store(o + N, y3);
  store(o + 2 * N, z3);
}

__global__ void __launch_bounds__(kThreads) proj_double_kernel(
    const uint32_t* __restrict__ p, uint32_t* __restrict__ out, uint32_t n) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t* pp = p + (size_t)i * 3 * N;
  const Elt x = load(pp), y = load(pp + N), z = load(pp + 2 * N);

  Elt t0 = mul(y, y);
  const Elt t00 = add(t0, t0);
  const Elt t0000 = add(t00, t00);
  Elt z3 = add(t0000, t0000);  // 8 Y^2
  Elt t1 = mul(y, z);
  Elt t2 = mul(b3(), mul(z, z));
  Elt x3 = mul(t2, z3);
  Elt y3 = add(t0, t2);
  z3 = mul(t1, z3);
  t1 = add(t2, t2);
  t2 = add(t1, t2);
  t0 = sub(t0, t2);
  y3 = add(x3, mul(t0, y3));
  x3 = mul(t0, mul(x, y));
  x3 = add(x3, x3);

  uint32_t* o = out + (size_t)i * 3 * N;
  store(o, x3);
  store(o + N, y3);
  store(o + 2 * N, z3);
}

inline unsigned blocks(uint32_t n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kzg_proj_add(const void* p, const void* q, void* out, long long n,
                            void* stream) {  // K3
  proj_add_kernel<<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, (uint32_t)n);
  return (int)cudaGetLastError();
}

extern "C" int kzg_proj_double(const void* p, void* out, long long n, void* stream) {  // K4
  proj_double_kernel<<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)out, (uint32_t)n);
  return (int)cudaGetLastError();
}
