// Field kernels for Hopper (sm_90a): the Fp and Fr Montgomery products (K1,
// K2), their constant-exponent chains (a^e for a host constant e, one launch
// per chain), and the small elementwise launchers that share their device
// functions (modular add and sub, compare, the blob ingest, and the modular
// sum along a leading axis).
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
// The blob ingest, kzg_fr_ingest, replaces the JAX package's
// ops/verify_kernels.py:347 blob_bytes_to_limbs and ops/limbs.py:292
// geq_mod with its any() (one XLA program there, one launch here): big-endian
// blob bytes [B, n, 32] in, little-endian Fr words [n, B, 8] out (the
// barycentric evaluation's domain-major layout; a prover blob is B = 1), and
// one byte that the kernel clears where an element is >= r.  It is bound by
// bytes (32 in and 32 out an element; 16.8 MB at a 64-blob chunk, 0.0050 ms
// at 3.35 TB/s).  One thread an element, two 16-byte loads and two 16-byte
// stores: an element is one 32-byte sector each way, so every sector moves
// whole whichever side is strided, and the transpose needs no shared memory.
// Neighbouring threads write neighbouring output elements.  The byte swap is
// one PRMT a word, the compare with r runs in registers, and a warp votes:
// a warp with a bad element stores 0 into the ok byte, which the wrapper set
// to 1 before the launch (every store writes the same value, so no atomic;
// the byte is the bool, so no torch op reads it).  Before this kernel the
// port ran the ingest as about 15 torch kernels over the chunk and the
// compare as kzg_fr_cmp over the words.
//
// The Fr difference, kzg_fr_sub, replaces the XLA op of the JAX package's
// ops/limbs.py:264 sub_mod at the path's broadcasts (the barycentric
// differences x_b - w_i, [1, B] - [n, 1]; a proof's [n] - [1]).  It is
// bound by the bytes it writes (8.4 MB from 130 KB at [4096, 64], 0.0025
// ms).  Its operands come as a 2-D view with a row and a column stride each
// (0 for a broadcast; ops/limbs.py sub_view), so it divides nothing at run
// time; a thread takes one column and R consecutive rows, loads an operand
// that is constant along the rows once, and stores each element with two
// 16-byte stores, neighbouring threads on neighbouring columns.
//
// So the generic compare (kzg_fr_cmp, ops/limbs.py eq and geq_const) and
// binary_kernel's Fr sub are off the main path; binary_kernel keeps K1, K2,
// the adds and the Fp sub (stage 2's negations).
//
// Operand indexing of the binary launchers: element i of the output reads
// element (i / div) % mod of each input, which covers a full operand (div 1,
// mod n), a broadcast scalar (mod 1) and a broadcast row or column of a 2-D
// batch, so callers never materialise a broadcast copy.  Operands and
// outputs of every launcher start on 16 bytes: the Python wrappers
// (ops/limbs.py _check_aligned) raise otherwise.
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

// out [rows, cols] = a - b mod r, operand element (r, c) at r rs + c cs of
// its base (strides in elements, 0 along a broadcast).  Two threads an
// element: thread x of a block row takes column (blockIdx.x blockDim.x + x)
// / 2 and stores half x % 2 of each of its elements, so a warp's store is
// 16 whole elements, 512 contiguous bytes (one thread an element stored a
// warp's 32 elements as two halves, each touching 32 sectors in part).  Both
// threads of a pair load the whole operands (the same addresses, one
// request) and compute the whole difference.  Block row y takes the R rows
// from R g of each row group g = blockIdx.y blockDim.y + y, blockDim.y
// gridDim.y groups apart.  An operand with row stride 0 is loaded once a
// thread; one with column stride 0 is the same for a warp (one broadcast).
template <int R>
__global__ void __launch_bounds__(kThreads) fr_sub_kernel(
    const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out, uint32_t rows,
    uint32_t cols, uint32_t a_rs, uint32_t a_cs, uint32_t b_rs, uint32_t b_cs) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x, c = t >> 1, h = t & 1;
  if (c >= cols) return;
  const uint32_t groups = (rows + R - 1) / R;
  uint32_t x[8], y[8], d[8];
  if (a_rs == 0) load_vec<8>(x, a + (size_t)c * a_cs * 2);
  if (b_rs == 0) load_vec<8>(y, b + (size_t)c * b_cs * 2);
  for (uint32_t g = blockIdx.y * blockDim.y + threadIdx.y; g < groups; g += gridDim.y * blockDim.y) {
#pragma unroll
    for (int k = 0; k < R; k++) {
      const uint32_t r = g * R + k;
      if (r < rows) {
        if (a_rs) load_vec<8>(x, a + ((size_t)r * a_rs + (size_t)c * a_cs) * 2);
        if (b_rs) load_vec<8>(y, b + ((size_t)r * b_rs + (size_t)c * b_cs) * 2);
        fr_sub(d, x, y);
        out[((size_t)r * cols + c) * 2 + h] =
            h ? make_uint4(d[4], d[5], d[6], d[7]) : make_uint4(d[0], d[1], d[2], d[3]);
      }
    }
  }
}

// Blob bytes in [B, n, 32] (big-endian elements) -> out [n, B, 8] words;
// *ok = 0 where some element is >= r.  Two threads an element: thread 2o +
// h takes half h (words 4h .. 4h + 3) of output element o = (i, b) =
// (o / B, o % B), which is input half 1 - h of element (b, i) byte-swapped
// and in reverse word order, so a pair loads one 32-byte sector and a warp
// stores 512 contiguous bytes.  Each thread compares its half with r's; one
// shuffle gives each the pair's other half, the high half deciding unless
// equal.  No thread returns before the shuffle and the vote, and a block is
// whole warps, so every lane of a warp reaches them.
__global__ void __launch_bounds__(kThreads) fr_ingest_kernel(
    const uint4* __restrict__ in, uint4* __restrict__ out, uint8_t* __restrict__ ok, uint32_t blobs,
    uint32_t elems, uint32_t total) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x, o = t >> 1, h = t & 1;
  uint32_t flags = 0;  // bit 1: this half > r's, bit 0: equal
  if (o < total) {
    const uint32_t i = o / blobs, b = o - i * blobs;
    const uint4 w = __ldg(in + ((size_t)b * elems + i) * 2 + (1 - h));
    const uint32_t v[4] = {__byte_perm(w.w, 0, 0x0123), __byte_perm(w.z, 0, 0x0123),
                           __byte_perm(w.y, 0, 0x0123), __byte_perm(w.x, 0, 0x0123)};
    bool eq = true, gt = false;
#pragma unroll
    for (int j = 3; j >= 0; j--) {  // the most significant word that differs from r's decides
      const uint32_t m = h ? Fr::mod(4 + j) : Fr::mod(j);
      if (eq && v[j] != m) {
        gt = v[j] > m;
        eq = false;
      }
    }
    flags = (gt ? 2u : 0u) | (eq ? 1u : 0u);
    out[(size_t)o * 2 + h] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, flags, 1);
  const uint32_t hi = h ? flags : other, lo = h ? other : flags;
  const bool bad = o < total && ((hi & 2u) || ((hi & 1u) && lo != 0));
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *ok = 0;
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

// out [rows, cols] = a - b mod r over strided operands (ops/limbs.py
// sub_view), `rows_per_thread` (1, 2, 4 or 8) rows a thread.  Blocks of TX
// threads (TX / 2 columns) by 256 / TX row groups, TX the power of two from
// 32 to 256 that covers 2 cols; the row groups beyond 65,535 blocks loop.
extern "C" int kzg_fr_sub(const void* a, const void* b, void* out, long long rows, long long cols,
                          long long a_rs, long long a_cs, long long b_rs, long long b_cs,
                          long long rows_per_thread, void* stream) {
  if (rows < 1 || cols < 1 || rows * cols >= (1LL << 31) || cols >= (1LL << 30) || a_rs < 0 || a_cs < 0 || b_rs < 0 ||
      b_cs < 0 || a_rs >= (1LL << 31) || a_cs >= (1LL << 31) || b_rs >= (1LL << 31) || b_cs >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  unsigned tx = 32;
  while (tx < kThreads && tx < 2 * cols) tx *= 2;
  const unsigned ty = kThreads / tx;
  const long long groups = (rows + rows_per_thread - 1) / rows_per_thread;
  const long long gy = (groups + ty - 1) / ty;
  const dim3 grid((unsigned)((2 * cols + tx - 1) / tx), (unsigned)(gy < 65535 ? gy : 65535));
  const cudaStream_t s = (cudaStream_t)stream;
#define SUB_CASE(R)                                                                           \
  if (rows_per_thread == R) {                                                                 \
    fr_sub_kernel<R><<<grid, dim3(tx, ty), 0, s>>>((const uint4*)a, (const uint4*)b, (uint4*)out, \
                                                  (uint32_t)rows, (uint32_t)cols, (uint32_t)a_rs, \
                                                  (uint32_t)a_cs, (uint32_t)b_rs, (uint32_t)b_cs); \
    return (int)cudaGetLastError();                                                           \
  }
  SUB_CASE(1) SUB_CASE(2) SUB_CASE(4) SUB_CASE(8)
#undef SUB_CASE
  return (int)cudaErrorInvalidValue;
}

// The blob ingest: bytes [blobs, elems, 32] -> out [elems, blobs, 8] words
// and ok (one byte, 1 on entry) cleared where an element is >= r.
extern "C" int kzg_fr_ingest(const void* in, void* out, void* ok, long long blobs, long long elems,
                             void* stream) {
  if (blobs < 1 || elems < 1 || blobs * elems >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const uint32_t total = (uint32_t)(blobs * elems);
  fr_ingest_kernel<<<(unsigned)((2LL * total + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, (uint8_t*)ok, (uint32_t)blobs, (uint32_t)elems, total);
  return (int)cudaGetLastError();
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
