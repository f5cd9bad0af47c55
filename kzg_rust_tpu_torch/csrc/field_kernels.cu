// Field kernels for Hopper (sm_90a): the Fp and Fr Montgomery products (K1,
// K2), their constant-exponent chains (a^e for a host constant e, one launch
// per chain), and the small elementwise launchers that share their device
// functions (modular add and sub, compare, and the modular sum along a
// leading axis).
//
// K1 replaces kzg_rust_tpu/ops/pallas_kernels.py:248 mont_mul_fp_pallas and
// K2 replaces :252 mont_mul_fr_pallas (one factory, _make_mont_mul :202).
// The chains, kzg_fp_pow_const and kzg_fr_pow_const, are K1's and K2's
// products in one launch: the JAX package runs each such chain as one jitted
// fori_loop (kzg_rust_tpu/ops/limbs.py:513 mont_pow_const).  The verify path
// launches two, the Fermat inversion d^(r-2) of the product-tree root and
// x^4096 in the barycentric formula, both over npad blobs.
//
// The domain sum, kzg_fr_sum_rows, replaces the XLA op of the JAX package's
// limbs.py:482 sum_mont_redc: one launch sums [k, inner] Fr elements along
// k (the barycentric evaluation's [4096, blobs], a proof's [4096, 1]).  It
// is bound by bytes (a raw add a word against 4 bytes), and at the path's
// 8 MB and 128 KB by the latency of a launch and of a cross-block sum: its
// design (at the kernel) takes 16-byte loads over the whole card with
// 64-bit column sums that need no reduction per add, and adds the blocks'
// partial sums in each tile's last block, with one reduction a column.
//
// What bounds them at the path's shapes, and what the design does about it.
// - Bytes, at K2's wide product-tree levels and barycentric terms (up to
//   16.7M elements, 537 MB an operand at n = 4096): a product is ~600
//   (Fp) or ~272 (Fr) 32-bit multiply-adds against 144 or 96 bytes, which on
//   this card is close to its bytes-to-multiply-add balance.  Each thread
//   loads and stores its element with 16-byte accesses (3 for Fp, 2 for Fr),
//   so a warp's accesses cover whole sectors and the L1 serves the rest of
//   each line, where word-by-word loads touched a sector per thread and word.
// - Launch latency, at the 64- to 8192-element launches that are most of
//   the path's products: a launch costs the host a wrapper call and the card
//   a few microseconds whatever its width.  The chains, which were 832 of
//   the ~950 launches of a batch, are one launch each.
// - Inside a chain, the latency of one dependent product: every squaring
//   waits for the last.  The element stays in registers from the first
//   product to the last; 80% of the chains' products are squarings, which
//   take the SOS squaring (field.cuh sos_sqr: the cross products once) at
//   ~0.8 of a product's instructions; and the products run on the
//   carry-chain cores (field.cuh cios_mul).
// The tensor cores, TMA and wgmma are not used: every element is a different
// multi-word integer, so no tile is shared across rows for a matrix product
// to reuse, and each block moves a few kilobytes once, which 16-byte loads
// already do at full rate.  The TPU kernel's devices (12-bit limbs, int8
// Toeplitz REDC on the MXU, roll-and-mask shifts, carry lookahead) answer a
// machine without a 32-bit multiplier and are not carried over.
//
// Operand indexing of the binary launchers: element i of the output reads
// element (i / div) % mod of each input, which covers a full operand (div 1,
// mod n), a broadcast scalar (mod 1) and a broadcast row or column of a 2-D
// batch, so callers never materialise a broadcast copy.  Operands and
// outputs of the binary launchers and the chains start on 16 bytes: the
// Python wrappers (ops/limbs.py _check_aligned) raise otherwise.
//
// C interface: every entry point launches on the given stream and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.

#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 256;

// floor(2^288 / r), the domain sum's Barrett factor (the CPU tests parse it).
constexpr unsigned long long kFrBarrettMu = 0x2355094edull;

// v = S mod r for S (nine words) < 2^288: Barrett's quotient q =
// floor(floor(S / 2^224) mu / 2^64) is at most floor(S / r) and at least
// floor(S / r) - 2 (dropping S's low 224 bits and mu's fraction each lose
// less than one), so S - q r < 3r < 2^257, and two conditional subtracts
// of r end it.  q < 2^34: two words.
__device__ __forceinline__ void fr_barrett(uint32_t* v, const uint32_t* w) {
  const unsigned long long q = __umul64hi((unsigned long long)w[8] << 32 | w[7], kFrBarrettMu);
  const uint32_t q0 = (uint32_t)q, q1 = (uint32_t)(q >> 32);
  uint32_t qr[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, m[8];
#pragma unroll
  for (int j = 0; j < 8; j++) m[j] = Fr::mod(j);
  mad_row<8>(qr, m, q0);      // q0 r into words 0..8
  mad_row<8>(qr + 1, m, q1);  // q1 r 2^32 into words 1..9 (the sum is below 2^(32 * 10))
  uint32_t d[9];
  unsigned long long borrow = 0;
#pragma unroll
  for (int j = 0; j < 9; j++) {  // S - q r, exact: below 3r
    const unsigned long long t = (unsigned long long)w[j] - qr[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = t >> 63;
  }
#pragma unroll 1
  for (int rep = 0; rep < 2; rep++) {
    uint32_t e[9];
    borrow = 0;
#pragma unroll
    for (int j = 0; j < 9; j++) {
      const unsigned long long t = (unsigned long long)d[j] - (j < 8 ? Fr::mod(j) : 0u) - borrow;
      e[j] = (uint32_t)t;
      borrow = t >> 63;
    }
    if (!borrow) {
#pragma unroll
      for (int j = 0; j < 9; j++) d[j] = e[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; j++) v[j] = d[j];
}

enum Op { kMul = 0, kAdd = 1, kSub = 2 };

template <class F, int OP>
__global__ void __launch_bounds__(kThreads) binary_kernel(
    const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out,
    uint32_t n, uint32_t a_div, uint32_t a_mod, uint32_t b_div, uint32_t b_mod) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  constexpr int N = F::N, V = N / 4;
  uint32_t x[N], y[N], r[N];
  load_vec<N>(x, a + (size_t)((i / a_div) % a_mod) * V);
  load_vec<N>(y, b + (size_t)((i / b_div) % b_mod) * V);
  if (OP == kMul) {
    cios_mul<F>(r, x, y);
  } else if (OP == kAdd) {
    add_mod<F>(r, x, y);
  } else {
    sub_mod<F>(r, x, y);
  }
  store_vec<N>(out + (size_t)i * V, r);
}

// out[i] = (a == b) for mode 0, (a >= b) as integers for mode 1.
template <int N>
__global__ void __launch_bounds__(kThreads) cmp_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint8_t* __restrict__ out,
    uint32_t n, uint32_t a_div, uint32_t a_mod, uint32_t b_div, uint32_t b_mod, int mode) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t* x = a + (size_t)((i / a_div) % a_mod) * N;
  const uint32_t* y = b + (size_t)((i / b_div) % b_mod) * N;
  bool eq = true, ge = true;
#pragma unroll
  for (int j = N - 1; j >= 0; j--) {  // the most significant differing word decides
    const uint32_t u = x[j], v = y[j];
    if (eq && u != v) {
      ge = u > v;
      eq = false;
    }
  }
  out[i] = mode == 0 ? (uint8_t)eq : (uint8_t)ge;
}

// The domain sum, x [k, inner, 8] Fr words (each < r) -> out [inner, 8],
// their modular sum along axis 0, in one launch.  The JAX package's
// sum_mont_redc idea: sum raw words, reduce once.  An element is two
// 16-byte halves; half h of column c is "pair" 2c + h, P = 2 inner of them
// a row.  A block of T threads takes Q neighbouring pairs (a tile, Q even,
// so a column never straddles two) over R = T / Q row lanes: thread (q, r)
// of row block rb adds the four words of its pair over rows rb R + r,
// rb R + r + R row_blocks, ... into four 64-bit column sums, four loads in
// flight (no reduction per add: k < 2^32 rows of 32-bit words cannot
// overflow them).  Neighbouring threads read neighbouring 16-byte halves.
// The block's row lanes are summed by a halving tree in shared memory, and
// its pairs' sums go to partials [row blocks, P, 4] (scratch the wrapper
// allocates).  The last row block of each tile to finish (a ticket a tile:
// zero words that the caller owns, ops/limbs.py sum_tickets, and that block
// resets, as M2's ticket in msm_kernels.cu; so a CUDA graph may replay the
// launch) adds the tile's row-block sums, all its threads loading at once,
// and then each of its Q / 2 columns is reduced by one thread: the eight
// column sums carried into nine words S < 2^288, then S mod r by Barrett's
// quotient (below).
template <int T, int Q>
__global__ void __launch_bounds__(T) sum_rows_kernel(
    const uint4* __restrict__ x, ulonglong2* __restrict__ partials, unsigned* __restrict__ tickets,
    uint4* __restrict__ out, uint32_t k, uint32_t inner, uint32_t tiles) {
  constexpr int R = T / Q, S = 2 * Q;  // S 16-byte slots of partial sums a tile
  __shared__ unsigned long long red[T][4];
  __shared__ bool last;
  const uint32_t P = 2 * inner, q = threadIdx.x % Q, r = threadIdx.x / Q;
  const uint32_t tile = blockIdx.x % tiles, rb = blockIdx.x / tiles, row_blocks = gridDim.x / tiles;
  const uint32_t p = tile * Q + q;
  unsigned long long acc[4] = {0, 0, 0, 0};
  if (p < P) {
    const uint32_t step = row_blocks * R;
    uint32_t j = rb * R + r;
    for (; j + 3 * step < k; j += 4 * step) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; u++) v[u] = __ldg(x + (size_t)(j + u * step) * P + p);
#pragma unroll
      for (int u = 0; u < 4; u++) {
        acc[0] += v[u].x;
        acc[1] += v[u].y;
        acc[2] += v[u].z;
        acc[3] += v[u].w;
      }
    }
    for (; j < k; j += step) {
      const uint4 v = __ldg(x + (size_t)j * P + p);
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; c++) red[threadIdx.x][c] = acc[c];
  __syncthreads();
#pragma unroll 1
  for (uint32_t h = R / 2; h > 0; h /= 2) {
    if (r < h) {
#pragma unroll
      for (int c = 0; c < 4; c++) red[threadIdx.x][c] += red[threadIdx.x + h * Q][c];
    }
    __syncthreads();
  }
  if (r == 0 && p < P) {
    ulonglong2* o = partials + ((size_t)rb * P + p) * 2;
    o[0] = make_ulonglong2(red[q][0], red[q][1]);
    o[1] = make_ulonglong2(red[q][2], red[q][3]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1u) == row_blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The tile's S slots over T / S lanes each: lane l adds row blocks l,
  // l + T / S, ..., four loads in flight; then a halving tree over the lanes.
  const uint32_t slot = threadIdx.x % S, lane = threadIdx.x / S, lanes = T / S;
  const bool live = tile * S + slot < 2 * P;  // a ragged last tile
  const ulonglong2* src = partials + (size_t)tile * S + slot;
  unsigned long long s0 = 0, s1 = 0;
  if (live) {
    uint32_t b = lane;
    for (; b + 3 * lanes < row_blocks; b += 4 * lanes) {
      ulonglong2 v[4];
#pragma unroll
      for (int u = 0; u < 4; u++) v[u] = __ldcg(src + (size_t)(b + u * lanes) * 2 * P);
#pragma unroll
      for (int u = 0; u < 4; u++) {
        s0 += v[u].x;
        s1 += v[u].y;
      }
    }
    for (; b < row_blocks; b += lanes) {
      const ulonglong2 v = __ldcg(src + (size_t)b * 2 * P);
      s0 += v.x;
      s1 += v.y;
    }
  }
  red[threadIdx.x][0] = s0;
  red[threadIdx.x][1] = s1;
  __syncthreads();
#pragma unroll 1
  for (uint32_t h = lanes / 2; h > 0; h /= 2) {
    if (lane < h) {
      red[threadIdx.x][0] += red[threadIdx.x + h * S][0];
      red[threadIdx.x][1] += red[threadIdx.x + h * S][1];
    }
    __syncthreads();
  }
  const uint32_t c = tile * (Q / 2) + threadIdx.x;
  if (threadIdx.x < Q / 2 && c < inner) {
    // Column c's sums are slots 4t .. 4t + 3, two words each.  Word j of S
    // is column sum j plus the carry from below; each carry stays at most
    // k, so no 64-bit sum overflows, and S < k r < 2^287.
    uint32_t w[9];
    unsigned long long carry = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const unsigned long long v = red[4 * threadIdx.x + j / 2][j % 2] + carry;
      w[j] = (uint32_t)v;
      carry = v >> 32;
    }
    w[8] = (uint32_t)carry;
    uint32_t v[8];
    fr_barrett(v, w);
    out[2 * c] = make_uint4(v[0], v[1], v[2], v[3]);
    out[2 * c + 1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
  if (threadIdx.x == 0) tickets[tile] = 0;
}

// out[i] = a[i]^e in Montgomery form, one thread per element (field.cuh
// pow_const: the table a^1..a^top in this thread's column of shared memory,
// then four squarings and a product a digit).  Every thread reads and writes
// only its own table column, so the block never synchronises and a thread
// past n returns at once.
template <class F, int T>
__global__ void __launch_bounds__(T) pow_kernel(const uint4* __restrict__ a,
                                                uint4* __restrict__ out, uint32_t n,
                                                const __grid_constant__ PowDigits e) {
  extern __shared__ uint32_t table[];
  const uint32_t i = blockIdx.x * T + threadIdx.x;
  if (i >= n) return;
  constexpr int N = F::N, V = N / 4;
  uint32_t x[N], acc[N];
  load_vec<N>(x, a + (size_t)i * V);
  pow_const<F, T>(acc, x, table + threadIdx.x, e);
  store_vec<N>(out + (size_t)i * V, acc);
}

inline unsigned blocks(uint32_t n) { return (n + kThreads - 1) / kThreads; }

template <class F, int OP>
int launch_binary(const void* a, const void* b, void* out, long long n, long long a_div,
                  long long a_mod, long long b_div, long long b_mod, void* stream) {
  binary_kernel<F, OP><<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (uint4*)out, (uint32_t)n, (uint32_t)a_div,
      (uint32_t)a_mod, (uint32_t)b_div, (uint32_t)b_mod);
  return (int)cudaGetLastError();
}

template <int N>
int launch_cmp(const void* a, const void* b, void* out, long long n, long long a_div,
               long long a_mod, long long b_div, long long b_mod, int mode, void* stream) {
  cmp_kernel<N><<<blocks((uint32_t)n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint8_t*)out, (uint32_t)n, (uint32_t)a_div,
      (uint32_t)a_mod, (uint32_t)b_div, (uint32_t)b_mod, mode);
  return (int)cudaGetLastError();
}

// A block of T threads takes top N words of shared memory a thread: 92,160
// bytes for Fp at T = 128 and 15 entries, above the 48 KB that a launch gets
// without the kernel's opt-in.  The opt-in is a function attribute of the
// current device's context, so it is set at every launch, to what this one
// needs (a host call, next to a chain of a few hundred microseconds).
template <class F, int T>
int launch_pow_t(const void* a, void* out, long long n, const PowDigits& e, cudaStream_t s) {
  const size_t smem = (size_t)e.top * F::N * 4 * T;
  const cudaError_t opt_in =
      cudaFuncSetAttribute(pow_kernel<F, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  pow_kernel<F, T><<<(unsigned)((n + T - 1) / T), T, smem, s>>>((const uint4*)a, (uint4*)out,
                                                              (uint32_t)n, e);
  return (int)cudaGetLastError();
}

template <class F>
int launch_pow(const void* a, void* out, long long n, const void* digits, long long count,
               void* stream) {
  if (count < 1 || count > kPowMaxDigits) return (int)cudaErrorInvalidValue;
  PowDigits e{};
  e.count = (uint32_t)count;
  for (long long k = 0; k < count; k++) {
    e.d[k] = ((const uint8_t*)digits)[k];
    if (e.d[k] > kPowMaxEntry) return (int)cudaErrorInvalidValue;
    e.top = e.d[k] > e.top ? e.d[k] : e.top;
  }
  if (e.d[0] == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (block_threads(n)) {
    case 128: return launch_pow_t<F, 128>(a, out, n, e, s);
    case 64: return launch_pow_t<F, 64>(a, out, n, e, s);
    default: return launch_pow_t<F, 32>(a, out, n, e, s);
  }
}

}  // namespace

#define BINARY_ENTRY(name, F, OP)                                                          \
  extern "C" int name(const void* a, const void* b, void* out, long long n, long long a_div, \
                      long long a_mod, long long b_div, long long b_mod, void* stream) {     \
    return launch_binary<F, OP>(a, b, out, n, a_div, a_mod, b_div, b_mod, stream);          \
  }

BINARY_ENTRY(kzg_fp_mont_mul, Fp, kMul)  // K1
BINARY_ENTRY(kzg_fr_mont_mul, Fr, kMul)  // K2
BINARY_ENTRY(kzg_fp_add, Fp, kAdd)
BINARY_ENTRY(kzg_fp_sub, Fp, kSub)
BINARY_ENTRY(kzg_fr_add, Fr, kAdd)
BINARY_ENTRY(kzg_fr_sub, Fr, kSub)

#define POW_ENTRY(name, F)                                                                 \
  extern "C" int name(const void* a, void* out, long long n, const void* digits,          \
                      long long count, void* stream) {                                    \
    return launch_pow<F>(a, out, n, digits, count, stream);                               \
  }

POW_ENTRY(kzg_fp_pow_const, Fp)  // K1's chain: digits on the host, count of them
POW_ENTRY(kzg_fr_pow_const, Fr)  // K2's chain

extern "C" int kzg_fp_cmp(const void* a, const void* b, void* out, long long n, long long a_div,
                          long long a_mod, long long b_div, long long b_mod, int mode,
                          void* stream) {
  return launch_cmp<12>(a, b, out, n, a_div, a_mod, b_div, b_mod, mode, stream);
}

extern "C" int kzg_fr_cmp(const void* a, const void* b, void* out, long long n, long long a_div,
                          long long a_mod, long long b_div, long long b_mod, int mode,
                          void* stream) {
  return launch_cmp<8>(a, b, out, n, a_div, a_mod, b_div, b_mod, mode, stream);
}

// The domain sum: x [k, inner, 8] -> out [inner, 8]; partials [row_blocks,
// 2 inner, 4] 64-bit scratch, tickets a zero word a tile; blocks of
// `threads` (256, 64 or 32) over `pairs` (2, 4, 8 or 16) halves a block (a
// tile), 2 inner / pairs tiles (rounded up) a row block: ops/limbs.py
// sum_config picks them.
extern "C" int kzg_fr_sum_rows(const void* x, void* partials, void* tickets, void* out, long long k,
                               long long inner, long long threads, long long pairs,
                               long long row_blocks, void* stream) {
  if (k < 1 || k >= (1LL << 32) || inner < 1 || inner >= (1LL << 30) || row_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (2 * inner + pairs - 1) / pairs;
  if (tiles * row_blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(tiles * row_blocks);
#define SUM_CASE(T, Q)                                                                         \
  if (threads == T && pairs == Q) {                                                           \
    sum_rows_kernel<T, Q><<<grid, T, 0, s>>>((const uint4*)x, (ulonglong2*)partials,           \
                                            (unsigned*)tickets, (uint4*)out, (uint32_t)k,    \
                                            (uint32_t)inner, (uint32_t)tiles);               \
    return (int)cudaGetLastError();                                                           \
  }
  SUM_CASE(256, 16) SUM_CASE(256, 8) SUM_CASE(256, 4) SUM_CASE(256, 2)
  SUM_CASE(64, 16) SUM_CASE(64, 8) SUM_CASE(64, 4) SUM_CASE(64, 2)
  SUM_CASE(32, 16) SUM_CASE(32, 8) SUM_CASE(32, 4) SUM_CASE(32, 2)
#undef SUM_CASE
  return (int)cudaErrorInvalidValue;
}
