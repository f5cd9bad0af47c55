#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kzg_rust_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure of which exits non-zero without the final line:

1. build the CUDA kernels from kzg_rust_tpu_torch/csrc/ (nvcc, sm_90a) and
   print the build seconds, what ptxas reported, the SASS instructions of
   the Fp and Fr Montgomery product and squaring and of one lane of kernel
   A's product over 2 and 4 lanes (where the toolkit has cuobjdump), and
   the card's name and power limit;
1b. build and load the native C++ host engine (native/kzg_native.cpp, g++
   -march=native for this machine's CPU) and print its path, ABI version,
   build seconds and the CPU count; a failed build fails the run;
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, exactly, edge lanes included, and time
   both with CUDA events (a kernel bound by bytes on operands the L2 cache
   does not hold); the K4 chain also against as many one-step K4
   launches, and the constant-exponent chains of K1 and K2 against the
   same chains as launch sequences of K1 or K2, which are timed too;
   stage 1's kernels A (decompression) and B (the subgroup check), the K5
   rows, at 2 x 4096 and 2 x 64 points on valid, off-subgroup and
   adversarial rows, A in each of its variants (1, 2 or 4 lanes a point)
   and B in each of its (lanes an add x groups a point, the serial
   tree 4 x 1 included) with ptxas's registers and spills, B's variants
   also swept at every stage-1 width from 128 to 8,192 points, and stage 1
   whole (A, the K4 chain, B; also with B's serial tree) against its plain
   version with its flags in every B variant on four cases (all decode and
   in the subgroup, none in it, adversarial rows, one row that does not
   decode but is in it), each replayed from a CUDA graph; the domain sum (one launch) at a chunk's [4096, 64], a
   proof's [4096, 1] and [4096, 4096], and twice replayed from a CUDA
   graph on new terms with its own tickets, a direct sum of more tiles
   between the replays (the tickets reset, and no other sum reaches the
   graph's); the
   prover's M1 (GLV digits) and M2 (the MSM after the digits, one launch)
   at mainnet width, edge and ripple scalars and an infinity column
   included, M1 in each of its variants (8 or 1 lanes a scalar) beside
   an empty kernel of its grid timed the same way (the launch floor), M2 also
   on a table of repeated and negated points (P == Q, P == -Q, infinity)
   and at every (accumulators, block) of its sweep; the verify
   path's small launchers at the shapes it gives them: the Fr difference
   at a chunk's [4096, 64] and at [4096, 4096] in each of its rows-a-thread
   variants, at [64] and a proof's [4096] - [1]; the blob ingest and check
   at a chunk's [64, 4096, 32] and a prover blob's [4096, 32] on canonical
   and planted non-canonical elements, and replayed from a CUDA graph on a
   bad, a good and a bad chunk (its flag reset each replay); the Fp
   negation at stage 2's [66, 4096, 6] lanes;
2b. hold the engine against the golden model on this machine's CPU, exactly:
   SHA-256 against hashlib, the G1 and G2 codecs (invalid encodings
   included), G1 and G2 multiplies, the G1 lincomb, the pairing (true,
   false, with infinity) and the barycentric evaluation of four mainnet
   blobs (also against ``TorchBackend.barycentric_eval`` on the card), each
   timed beside its golden twin;
3. drive the verify path, ``Kzg.verify_blob_kzg_proof_batch`` through
   ``TorchBackend()`` on the mainnet setup: the 22 mainnet batch vectors,
   then batches of n = 64, 512 and 4096 sampled (numpy seed) from the six
   valid ``verify_blob_kzg_proof`` vectors, with five outcome lanes each
   (valid, swapped proof, non-canonical blob, malformed point, non-subgroup
   point, the bad row in the batch's last chunk; the n = 64 lanes
   cross-checked against the golden backend, and the pairing inputs of its
   valid and swapped batches also put through the pure-Python pairing),
   the launch counts of one valid batch, stage times and host step times
   (the pairing in the engine); at n = 512 and 4096, in the chunked regime,
   every lane held word for word (flags and ys of the packed fetch) against
   the full-width path; at n = 4096 the peak device memory under its cap,
   one replay of the barycentric graph against the same chunk launched
   directly, the device operations one replay runs by name
   (torch.profiler; ``--replay-kernels`` measures them alone, also for an
   older checkout), the sweeps of both chunk widths (stage 1 in chunks held
   against full width), one batch under torch.profiler (top device
   operations, the share of upload time beside a kernel), and a device
   batch beside the engine's threads verifying the same batch;
3b. drive the prover path through ``TorchBackend()``: build the mainnet
   MSM table on the card (time, bytes, peak memory), run every mainnet
   vector of ``blob_to_kzg_commitment``, ``compute_kzg_proof``,
   ``compute_blob_kzg_proof`` and ``verify_blob_kzg_proof``, two in-domain
   proofs (z = the first and the last root) checked by y and by
   ``verify_kzg_proof``, the launch counts of one commit and one proof (M1
   and M2 once each, no K3 inside the MSM), host and device times;
3c. host placement on the same machine: with ``KZG_TORCH_EVAL=host`` the 22
   batch vectors and the five lanes at both n, in the engine's fused
   context with no launch; with ``KZG_TORCH_PROVER=host`` (and
   ``KZG_TORCH_EVAL=host``) the 94 single-blob vectors; host-clock times
   (median of 3) printed beside the card's on one line;
3d. ``auto`` placement on the same backend: ``KZG_TORCH_EVAL=auto`` at each
   n and ``KZG_TORCH_PROVER=auto`` for a commit and a proof, each decision
   printed with its terms (link, upload, the card's estimate, the host's
   budget) and its time; where phases 3-3c measured one side faster in
   every run, auto must pick it; the 22 batch vectors and the lanes give
   the same outcomes under device, host and auto, and so do the commit and
   the proof; the line through the device path's end-to-end times, which
   ``backends/placement.py``'s constants are fitted to;
3e. the 92 mainnet ``verify_kzg_proof`` vectors and every
   ``tests/vectors_minimal`` vector (the minimal setup: the kernels at its
   4-element shapes) under device, host, auto and host-piecewise placement,
   every outcome the vector's; under device the pairing inputs the mainnet
   vectors hand the engine are recorded (as are phase 3's valid and
   swapped batches' at n = 64);
3f. the sharded paths on a mesh of two shards on the one card: every lane
   of the batch at n = 64 and 512, the three stages alone at n = 64, a
   commit and a proof on the point mesh, the split MSM and the
   domain-split ``barycentric_eval``, each equal to the unsharded path's
   (flags, affine points, outcomes) and timed beside it;
3g. ``parallel/distributed.py`` as a world of one rank over NCCL on two
   local shards of the card: the 2-axis stages at n = 64 and MSM at
   mainnet width, equal to the unsharded path's;
3h. the device pairing (``csrc/pairing_kernels.cu``, run before 3f): P1
   ``kzg_fp12_op`` word for word against its plain version for each op
   code at [4096] (the Granger-Scott squaring on cyclotomic elements), P2
   ``kzg_miller_loop`` at [2, 1] and [2, 64] and P3 ``kzg_final_exp``
   (its value, with the real |x| at K = 1 and 64 and with the bits (1, 0))
   against theirs, P2 and P3 timed at K = 1, 64 and 1024, ptxas's
   registers and stack for the source; every recorded pairing and five
   infinity lanes through ``ops/pairing.pairings_verify_device``, one at a
   time and in one batched call, each answer the engine's and the
   expected one; one check at K = 1 on the host clock beside the
   engine's;
4. check that every kernel of the path launched in the n = 64 batch, one
   commit or one proof, that at every n a valid batch made the launches
   ``batch_launches`` counts, stage 1 being exactly kernel A, the
   window-base chain and kernel B a chunk (nothing else) and the
   barycentric evaluation its 48 launches at full width (the Fermat
   inversion and x^4096 one each of the Fr chain, the domain sum and the
   ingest one each, the Fr difference two) or one graph replay a chunk (48
   kernels), the ingest once in a commit and a proof and the generic Fr
   compare in no run, and print the report lines and the ``kernels`` JSON
   line.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside this script, it exits 2 and prints no result.
``--replay-kernels`` or ``--batches`` runs only the build and
``replay_kernels`` or ``batches_alone``, for the package beside this
script (a copy beside an older checkout measures that checkout).
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0x5EED
BAD_FROM_END = 3  # the corrupted lane sits near the end of the batch
# A block's batch, the first size of the chunked regime, and bulk sync; the
# first is cross-checked on golden.
BATCH_SIZES = (64, 512, 4096)
# The chunk widths swept at the largest n (blobs; "full" is one chunk), and
# the cap on its peak device memory: the caching allocator's peak reserved
# bytes over four batches (it holds the barycentric graph's private pool,
# whose blocks the allocated count leaves out), from an emptied cache; the
# first card runs of the chunked path reserved 0.91 and 0.98 GB.
BARY_SWEEP = (64, 128, 256, 512)
# The batch sizes the two-shard mesh runs (phase 3f); the first also runs
# the stages alone there and in the one-rank world (phase 3g).
SHARDED_SIZES = (64, 512)
STAGE1_SWEEP = (512, 1024, 2048, "full")
PEAK_MEM_CAP = 1_200_000_000
# Built and held against their plain versions, but no counted run (an
# n = 64 batch, a commit, a proof) launches them: the barycentric domain sum
# runs in kzg_fr_sum_rows, the window-base chains run K4 as
# kzg_proj_double_chain, one launch for all their doublings
# (kzg_proj_double is K4 alone), and the mixed add runs inside M2
# (kzg_proj_add_mixed is it alone).  Stage 1's decompression and subgroup
# check are kernels A and B, which took the Fp compare, the Fp add and the
# square root's Fp chain off the verify path: kzg_fp_cmp and
# kzg_fp_pow_const run only in the MSM table's one-off build (its infinity
# mask and batched inversion), kzg_fp_add in no path.  The blob ingest
# (kzg_fr_ingest) checks the blobs' canonicality, so the generic Fr compare
# runs in no path either.  The device pairing (P1-P3) is an op-level
# entry point of its own, ``ops/pairing.pairings_verify_device``: the
# backends' pairing is the host engine's, as in the JAX package, so no
# counted run launches it (phase 3h drives it).
OFF_PATH = {
    "kzg_fr_add", "kzg_proj_double", "kzg_proj_add_mixed", "kzg_fp_cmp", "kzg_fp_add", "kzg_fp_pow_const", "kzg_fr_cmp",
    "kzg_fp12_op", "kzg_miller_loop", "kzg_final_exp",
}
# Phase 2 shapes, each one the main path gives the kernel at n = 4096 or 64
# (or gave it before stage 1 ran in kernels A and B, kept so that each
# kernel's time stays comparable across PRs): K1 at stage 1's former width
# (2 * 4096 points) and at stage 2's beta products (66 windows x 4096 blobs
# x 3 phi lanes); K2 and the Fr launchers at a product-tree level of the
# barycentric evaluation (4096 blobs x 64), and K2 at its widest, the
# barycentric terms (4096 x 4096); the square-root chain at stage 1's widths
# (2 * 4096 and 2 * 64 points; its body runs inside kernel A), the Fermat
# and x^4096 chains over the blobs of one barycentric chunk
# (BARY_CHUNK_BLOBS, at n = 4096) and of the padded batch (64, and 4096 at
# full width as before the chunked regime); the domain sum at
# n = 64 and a chunk (4096 rows of 64 blobs) and in a proof (4096 rows of
# one); K3 at the subgroup check's former first
# tree level (8 of its 17 window rows x 8192 points) and at stage 2's
# widest, the right-hand tree's first level (66 windows x 4096 blobs x 4
# lanes, halved); K4 and its chain at the window-base chain's widths
# (n = 4096 and n = 64); stage 1's kernels A and B and stage 1 whole at its
# widths (2 x 4096 and 2 x 64 points).  The prover's MSM at mainnet width:
# M1 over one blob's 4096 scalars, M2 over the [26, 16, 4096] table, the
# mixed add alone at M2's accumulator count.  The verify path's small
# launchers at the widest shapes it gives them at n = 4096: the barycentric
# differences (kzg_fr_sub, 4096 x 4096 from two broadcast [4096] operands),
# the domain sum (kzg_fr_sum_rows, [4096, 4096] in one launch), and the Fp negation of stage
# 2's selected Y words (kzg_fp_sub, zero minus 66 windows x 4096 blobs x 6
# lanes), stage 2 being the only stage that launches it; the barycentric
# launchers and K2 also at the shapes one chunk gives them (4096 domain
# rows x BARY_CHUNK_BLOBS blobs), which is where n = 4096 runs them now;
# the blob ingest at a chunk's bytes ([BARY_CHUNK_BLOBS, 4096, 32]) and a
# prover blob's ([4096, 32]).
SHAPES = {
    "fp": 8192,
    "fr": 262144,
    "fr_wide": 4096 * 4096,
    "fp_pow": (8192, 128),
    "fr_pow": (64, 4096),  # and BARY_CHUNK_BLOBS, first
    "sum": ((4096, 64), (4096, 1)),
    "add": (65536, 540672),
    "double": (8192, 128),
    "msm": 4096,
    "fr_path": 4096,
    "stage1": (8192, 128),
    "beta": (66, 4096, 3),
    "neg": (66, 4096, 6),
}
# Launches in one commit and one proof with z out of the domain (the MSM in
# each is M1 and M2, one launch each); those of one valid batch are
# batch_launches(npad): stage 1, the barycentric evaluation (48 launches at
# full width, one replay of its graph a chunk in the chunked regime) and
# stage 2 (3 Fp negations, one beta product, and the K3 trees: over the
# 132 npad left-hand and 264 npad right-hand lanes, the generator's 64
# windows, and the final add).
PATH_LAUNCHES = {"commit": 3, "proof": 53}
BARY_LAUNCHES = 48
# Stage 1 on the card: kernel A, the window-base chain, kernel B.
STAGE1_LAUNCHES = {"kzg_g1_decompress": 1, "kzg_proj_double_chain": 1, "kzg_g1_subgroup_check": 1}
# Stage 1's widths (2 npad points) from n = 64 to n = 4096, where kernel
# B's variants are swept, and B's serial variant (one group a point),
# which stage 1 whole is also timed with.
STAGE1_WIDTHS = (128, 256, 512, 1024, 2048, 4096, 8192)
SERIAL_B = (4, 1)
# M2's sweep on the card: (accumulators an SM, threads a block), each
# timed and held against its plain version; ops/msm.py takes the fastest
# as its default.
MSM_SWEEP = ((128, 128), (256, 128), (384, 128), (256, 256), (384, 384))
# The mainnet vectors of the prover phase, by kind, and how many each has.
PROVER_VECTORS = {
    "blob_to_kzg_commitment": 10,
    "compute_kzg_proof": 46,
    "compute_blob_kzg_proof": 14,
    "verify_blob_kzg_proof": 24,
}

# Published H100 SXM peaks (NVIDIA data sheet) and the integer pipe rate
# (CUDA C++ Programming Guide, arithmetic throughput table, compute
# capability 9.0: 64 32-bit integer multiply-adds per clock per SM).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
# Fp products in a complete add, a doubling and a mixed add as the curve
# kernels take them: RCB's products by b3 = 12 are adds there (the same
# canonical value), so 14 - 2, 9 - 1 and 13 - 2.
ADD_PRODUCTS, DOUBLE_PRODUCTS, MIXED_PRODUCTS = 12, 8, 11
# Kernel B's Fp products a point: 16 complete adds over the 17 window rows
# of z^2, beta X1 and the four cross products.
SUBGROUP_PRODUCTS = 16 * ADD_PRODUCTS + 5


# Probe kernels that differ only in what they do between loading two
# elements and storing one: nothing (an xor), a product, or a squaring of
# one operand xored with the other, for each field; and kernel A's Fp
# product over 2 and 4 lanes (one lane's instructions).
SASS_PROBE = r"""
#include "field.cuh"
using namespace kzg;
#define PROBE(name, N, body)                                                            \
  extern "C" __global__ void name(const uint32_t* a, const uint32_t* b, uint32_t* r) { \
    uint32_t x[N], y[N], z[N];                                                         \
    load_words<N>(x, a + N * threadIdx.x);                                             \
    load_words<N>(y, b + N * threadIdx.x);                                             \
    body;                                                                              \
    store_words<N>(r + N * threadIdx.x, z);                                            \
  }
#define XOR(N) for (int j = 0; j < N; j++) z[j] ^= y[j]
PROBE(probe_fp_load_store, 12, for (int j = 0; j < 12; j++) z[j] = x[j] ^ y[j])
PROBE(probe_fp_mont_mul, 12, fp_mont_mul(z, x, y))
PROBE(probe_fp_mont_sqr, 12, fp_mont_sqr(z, x); XOR(12))
PROBE(probe_fr_load_store, 8, for (int j = 0; j < 8; j++) z[j] = x[j] ^ y[j])
PROBE(probe_fr_mont_mul, 8, fr_mont_mul(z, x, y))
PROBE(probe_fr_mont_sqr, 8, fr_mont_sqr(z, x); XOR(8))
#define LANE_PROBE(L) \
  { uint32_t part[12 / L]; lane_mul<L>(part, x, y, y + 12 - 12 / L, threadIdx.x % L); \
    for (int j = 0; j < 12; j++) z[j] = j < 12 / L ? part[j] : 0u; }
PROBE(probe_fp_lane_mul_2, 12, LANE_PROBE(2))
PROBE(probe_fp_lane_mul_4, 12, LANE_PROBE(4))
"""


def sass_counts() -> dict | None:
    """SASS instructions (up to the last EXIT) of each SASS_PROBE kernel, or
    None where the toolkit has no cuobjdump."""
    from kzg_rust_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    src = os.path.join(_build.build_dir(), "sass_probe.cu")
    cubin = src[:-3] + ".cubin"
    with open(src, "w") as fh:
        fh.write(SASS_PROBE)
    subprocess.run(
        [nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-I", _build.CSRC, "-o", cubin, src],
        check=True,
        capture_output=True,
        timeout=300,
    )
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True, text=True, timeout=60).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", part)
        last_exit = max(i for i, op in enumerate(ops) if "EXIT" in op)
        counts[name] = last_exit + 1
    return counts


def ptxas_report() -> dict:
    """What ptxas said of each kernel the build compiled, by kernel and
    template arguments (e.g. "decompress_kernel 128 4"): (source, its
    registers line, its spill line)."""
    from kzg_rust_tpu_torch.ops import _build

    out = {}
    for src, info in _build.BUILD_INFO.items():
        kernel = spills = None
        for line in info["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # e.g. ..17decompress_kernelILi128ELi4EEEv..: decompress_kernel 128 4
                name = list(re.finditer(r"\d+([a-z_]+_kernel)((?:I|N3kzg2F[pr]E|Li\d+E)*)", m.group(1)))[-1]
                args = re.findall(r"N3kzg2(F[pr])E|Li(\d+)E", name.group(2))
                kernel = " ".join([name.group(1)] + ["".join(a) for a in args])
            elif "spill stores" in line:
                spills = line.strip()
            elif "registers" in line and kernel:
                out[kernel] = (src, line.split(":")[-1].strip(), spills)
    return out


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed and timed with CUDA events (no host time)."""
    import torch

    from kzg_rust_tpu_torch.ops import _build

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.capturing(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


def cold_graph_ms(fn, args, nbytes: int, l2: int, reps: int) -> float:
    """graph_ms of ``fn(*args)`` with the L2 cache (``l2`` bytes) cold: the
    captured calls cycle through copies of ``args`` spanning twice the L2,
    and every call's output stays alive, so no call finds its operands or
    output in the L2 (a call moves ``nbytes``)."""
    copies = [args] + [tuple(x.clone() for x in args) for _ in range(-(-2 * l2 // nbytes) - 1)]
    outputs = []

    def call():
        outputs.append(fn(*copies[len(outputs) % len(copies)]))

    ms = graph_ms(call, max(reps, len(copies)))
    del outputs[:], copies[1:]
    return ms


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of one call of ``fn`` over ``reps`` calls, each
    timed with CUDA events, after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def random_field(rng, modulus: int, n: int) -> list[int]:
    nbytes = (modulus.bit_length() + 7) // 8 + 8
    raw = rng.integers(0, 256, size=(n, nbytes), dtype="u1").tobytes()
    return [int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little") % modulus for i in range(n)]


def random_points(rng, n: int, device):
    """``n`` G1 points in Montgomery projective form: 16 golden points,
    each scaled by a random nonzero lambda (X, Y, Z all times lambda), so
    every row is its own representation; every 16th row is infinity."""
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.golden.field import P
    from kzg_rust_tpu_torch.ops import limbs as L

    base = [gc.g1_mul(gc.G1_GENERATOR, k) for k in random_field(rng, gc.R - 1, 15)] + [None]
    lams = random_field(rng, P - 1, n)
    rr = L.FP.mont_r
    vals = []
    for i in range(n):
        p = base[i % 16]
        lam = (lams[i] + 1) * rr % P
        vals += [0, lam, 0] if p is None else [p[0] * lam % P, p[1] * lam % P, lam]
    return L.to_device(L.FP, vals, device).reshape(n, 3, L.FP.nwords), base


def compressed_x(x: int, bits: int = 0x80) -> bytes:
    """The 48 big-endian bytes of x with ``bits`` or-ed into the first."""
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= bits
    return bytes(b)


def stage1_rows(prng) -> tuple[list[bytes], list[bytes], dict]:
    """Compressed G1 rows for stage 1's kernels: the adversarial rows (the
    decoders' G1_ENCODINGS and those of tests/test_torch_verify.py: a point
    off the subgroup, x = p, infinity with a payload, the sign bit or
    without the compression bit, x = p - 1, an x whose x^3 + 4 is not a
    square, x = 0, a valid point in both signs); the distinct rows: 128
    points of the subgroup, then 128 on the curve outside it, each in both
    signs; and each row's golden reading, (decodes, point, in subgroup)."""
    from kzg_rust_tpu_torch.errors import BadArgs
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.golden.field import P, R, fp_sqrt

    def both_signs(pt):
        return [gc.g1_compress(pt), gc.g1_compress(gc.g1_neg(pt))]

    def off_subgroup():
        while True:
            x = prng.randrange(P)
            y = fp_sqrt((x * x * x + 4) % P)
            if y is not None and not gc.g1_in_subgroup((x, y)):
                return (x, y)

    nonsquare = next(x for x in range(1, 1000) if fp_sqrt((x * x * x + 4) % P) is None)
    valid = gc.g1_mul(gc.G1_GENERATOR, prng.randrange(1, R))
    adversarial = G1_ENCODINGS + [
        gc.g1_compress(off_subgroup()),
        compressed_x(P),
        b"\xc0" + b"\x00" * 46 + b"\x01",
        b"\xe0" + b"\x00" * 47,
        b"\x40" + b"\x00" * 47,
        compressed_x(P - 1),
        compressed_x(nonsquare),
        compressed_x(0, 0xA0),
        b"\xc0" + b"\x00" * 47,
    ] + both_signs(valid)
    distinct = []
    for _ in range(128):
        distinct += both_signs(gc.g1_mul(gc.G1_GENERATOR, prng.randrange(1, R)))
    for _ in range(128):
        distinct += both_signs(off_subgroup())
    golden = {}
    for row in adversarial + distinct:
        try:
            pt = gc.g1_uncompress(row)
        except BadArgs:
            golden[row] = (False, None, None)
            continue
        golden[row] = (True, pt, gc.g1_in_subgroup(pt))
    return adversarial, distinct, golden


# Big-endian elements each ingest check plants, with where: r, r + 1, 2^255
# and 2^256 - 1 in the middle of the input, and r alone in the last row of
# the last blob.
INGEST_BAD = ("r", "r+1", "2^255", "2^256-1", "last")


def check_ingest(device, record, cold_ms) -> dict:
    """kzg_fr_ingest at a chunk's [64, 4096, 32] and a prover blob's
    [4096, 32], held word for word (words and flag) against its plain
    version: on random canonical elements with 0 and r - 1 leading, and with
    each bad element of INGEST_BAD planted alone.  Timed on the canonical
    chunk: the kernel alone (``ms``, L2 cold) and the wrapper with its flag
    fill (``wrapper_ms``).  Then one CUDA graph of the wrapper on a flag of
    its own, replayed on a bad chunk, a good chunk and a bad chunk: the flag
    reads False, True, False and the words equal the plain version's."""
    import torch

    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.golden.field import R
    from kzg_rust_tpu_torch.ops import _build
    from kzg_rust_tpu_torch.ops import limbs as L

    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def canonical(shape):
        x = torch.randint(0, 256, shape + (32,), dtype=torch.uint8, device=device, generator=gen)
        x[..., 0] &= 0x3F  # below 2^254 < r
        flat = x.view(-1, 32)
        flat[0], flat[1] = be(0), be(R - 1)
        return x

    def be(v):
        return torch.tensor(list(v.to_bytes(32, "big")), dtype=torch.uint8, device=device)

    def planted(x, name):
        y = x.clone()
        flat = y.view(-1, 32)
        values = {"r": R, "r+1": R + 1, "2^255": 1 << 255, "2^256-1": (1 << 256) - 1, "last": R}
        flat[-1 if name == "last" else flat.shape[0] // 2 + 7] = be(values[name])
        return y

    def packed(fn):
        def call(x):
            words, ok = fn(x)
            return torch.cat([words.reshape(-1), ok.reshape(1).to(torch.int32)])

        return call

    kernel, plain = packed(L.ingest_check), packed(L.ingest_check_plain)
    rows = []
    for shape in ((TB.BARY_CHUNK_BLOBS, SHAPES["fr_path"]), (SHAPES["fr_path"],)):
        good = canonical(shape)
        blobs, elems = (1,) + shape if len(shape) == 1 else shape
        flag = torch.empty((), dtype=torch.uint8, device=device)

        def launch_only(x, flag=flag, out_shape=shape[::-1] + (8,), blobs=blobs, elems=elems):
            out = torch.empty(out_shape, dtype=torch.int32, device=device)
            _build.launch("kzg_fr_ingest", device, x, out, flag, blobs, elems)
            return out

        nbytes = 2 * good.numel() + 1
        row = record(
            "kzg_fr_ingest",
            kernel,
            plain,
            (good,),
            "kzg_rust_tpu_torch/csrc/field_kernels.cu",
            "kzg_rust_tpu/ops/verify_kernels.py:347 (blob_bytes_to_limbs) + kzg_rust_tpu/ops/limbs.py:292 (geq_mod), XLA ops",
            nbytes,
            good.numel() // 4,
            50,
            keep=False,
            plain_reps=2,
            timed=launch_only,
        )
        for name in INGEST_BAD:
            bad = planted(good, name)
            got, want = kernel(bad), plain(bad)
            torch.cuda.synchronize()
            if not torch.equal(got, want) or bool(got[-1]):
                raise AssertionError(f"kzg_fr_ingest at {list(good.shape)} with {name} planted: words or flag disagree with the plain version")
        row["wrapper_ms"] = cold_ms(L.ingest_check, (good,), nbytes)
        # What the card's own copy kernel takes to read and write the same
        # bytes, timed as the row was.
        row["copy_same_bytes_ms"] = cold_ms(lambda x: x.clone(), (good,), nbytes)
        row["adversarial_equal"] = ["0", "r-1"] + list(INGEST_BAD)
        log(f"kernel kzg_fr_ingest at {list(good.shape)}: words and flag equal to plain with each of {json.dumps(row['adversarial_equal'])}; the wrapper (flag fill and launch) {row['wrapper_ms']:.4f} ms, torch's copy of the same bytes {row['copy_same_bytes_ms']:.4f} ms, L2 cold")
        rows.append(row)

    # The flag across replays of one graph: bad, good, bad.
    chunk = canonical((TB.BARY_CHUNK_BLOBS, SHAPES["fr_path"]))
    bad = planted(chunk, "last")
    buf, flag = torch.empty_like(chunk), torch.empty((), dtype=torch.uint8, device=device)
    buf.copy_(chunk)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        L.ingest_check(buf, flag)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.capturing(), torch.cuda.graph(graph):
        words, ok = L.ingest_check(buf, flag)
    seen = []
    for data in (bad, chunk, bad):
        buf.copy_(data)
        words.zero_()
        graph.replay()
        want_words, want_ok = L.ingest_check_plain(data)
        torch.cuda.synchronize()
        seen.append(bool(ok))
        if not torch.equal(words, want_words) or bool(ok) != bool(want_ok):
            raise AssertionError(f"kzg_fr_ingest: replay {len(seen)} of its CUDA graph disagrees with the plain version")
    if seen != [False, True, False]:
        raise AssertionError(f"kzg_fr_ingest: the flag read {seen} over bad, good, bad replays")
    log("kernel kzg_fr_ingest: one CUDA graph on its own flag, replayed on a bad, a good and a bad chunk: ok False, True, False, words equal to plain")
    rows[0].update(at_prover_blob=rows[1], graph_flag_replays=seen, kernels_line=True)
    return rows[0]


def subgroup_ptxas(lanes: tuple, n: int, sms: int, ptxas: dict) -> tuple:
    """ptxas's (registers, spills) of kernel B's variant ``lanes`` (lanes
    an add, groups) at ``n`` points."""
    width, groups = lanes
    if groups == 1:
        block = next(t for t in (128, 64, 32) if -(-n * width // t) >= sms or t == 32)
        name = f"subgroup_kernel {block}"
    else:
        name = f"subgroup_tree_kernel {width} {groups}"
    _, regs, spills = ptxas.get(name, (None, "not reported", "not reported"))
    return regs, spills


def lanes_label(lanes: tuple) -> str:
    return f"{lanes[0]}x{lanes[1]}"


def subgroup_variants(points, bases, bases2, want, n: int, sms: int, ptxas: dict) -> list[dict]:
    """Kernel B in each of its variants (lanes an add x groups a point) on
    these operands: held bit for bit against ``want`` (the plain
    version's), timed replayed (20 calls in a graph)."""
    import torch

    from kzg_rust_tpu_torch.ops import verify_kernels as V

    out = []
    for lanes in V.SUBGROUP_LANES:
        call = lambda p=points, x=bases, y=bases2, n_=lanes: V.subgroup_check_from_bases(p, x, y, lanes=n_)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 B at [{n}], lanes {lanes_label(lanes)}: disagrees with its plain version")
        regs, spills = subgroup_ptxas(lanes, n, sms, ptxas)
        out.append({"lanes": lanes_label(lanes), "lanes_a_point": lanes[0] * lanes[1], "ms": graph_ms(call, 20), "ptxas": regs, "spills": spills})
    return out


def subgroup_width_sweep(device, distinct, sms: int, ptxas: dict) -> dict:
    """Kernel B's variants at every stage-1 width of a batch from n = 64 to
    n = 4096 (2 npad points), on rows of the subgroup and off it, each held
    against the plain version: the sweep behind verify_kernels.
    subgroup_lanes."""
    import numpy as np
    import torch

    from kzg_rust_tpu_torch.ops import verify_kernels as V

    sweep = {}
    for n in STAGE1_WIDTHS:
        rows_s = [distinct[k % len(distinct)] for k in range(n)]
        comp = torch.from_numpy(np.frombuffer(b"".join(rows_s), np.uint8).reshape(n, 48).copy()).to(device)
        points, _ = V.g1_uncompress_points(comp)
        bases, bases2 = V.bases_chain(points)
        want = V.subgroup_check_from_bases_plain(points, bases, bases2)
        variants = subgroup_variants(points, bases, bases2, want, n, sms, ptxas)
        sweep[n] = {v["lanes"]: v["ms"] for v in variants}
        fastest = min(variants, key=lambda v: v["ms"])["lanes"]
        log(f"kernel K5 B sweep at [{n}]: lanes an add x groups -> ms " + "; ".join(f"{v['lanes']} {v['ms']:.4f}" for v in variants) + f"; fastest {fastest}, subgroup_lanes {lanes_label(V.subgroup_lanes(n, sms))}")
    return sweep


# An empty kernel with M1's launch, built beside the port's kernels: the
# floor of a launch timed as M1 is (replayed, L2 cold, same stream).
EMPTY_PROBE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel(const void*, void*, unsigned) {}
extern "C" int kzg_empty(const void* in, void* out, long long blocks, long long threads, void* stream) {
  empty_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(in, out, 0);
  return (int)cudaGetLastError();
}
"""


def empty_launcher():
    """ctypes entry of EMPTY_PROBE, built with nvcc for sm_90a."""
    import ctypes

    from kzg_rust_tpu_torch.ops import _build

    os.makedirs(_build.build_dir(), exist_ok=True)
    src = os.path.join(_build.build_dir(), "empty_probe.cu")
    lib = src[:-3] + ".so"
    with open(src, "w") as fh:
        fh.write(EMPTY_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", lib, src], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(lib).kzg_empty
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def glv_digit_variants(k, m1: dict, l2: int, ptxas: dict) -> list[dict]:
    """M1 in each of its variants (lanes a scalar; 1 is the one-thread
    design) on the scalars ``k``, digit for digit against the plain
    version, timed as M1's row is (L2 cold, replayed); and the floor, an
    empty kernel with the default variant's grid timed the same way."""
    import torch

    from kzg_rust_tpu_torch.ops import msm as M

    want = M.glv_digits_plain(k)
    m = k.shape[0]
    nbytes = m * (8 * 4 + 2 * M.GLV_NUM_WINDOWS)
    out = []
    for lanes in M.GLV_DIGIT_LANES:
        call = lambda x, n_=lanes: M.glv_digits_from_limbs(x, lanes=n_)  # noqa: E731
        got = call(k)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"M1 at [{m}], {lanes} lanes: disagrees with its plain version")
        name = "glv_digits_kernel" if lanes == 1 else f"glv_digits_lanes_kernel {lanes}"
        _, regs, spills = ptxas.get(name, (None, "not reported", "not reported"))
        ms = cold_graph_ms(call, (k,), nbytes, l2, 50)
        out.append({"lanes": lanes, "ms": ms, "ptxas": regs, "spills": spills})
    empty = empty_launcher()
    lanes = M.GLV_DIGIT_LANES[0]
    blocks, threads = -(-m // 32), 32 * lanes

    def launch_empty(x):
        o = torch.empty((2, M.GLV_NUM_WINDOWS, m), dtype=torch.int8, device=x.device)
        rc = empty(x.data_ptr(), o.data_ptr(), blocks, threads, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel: CUDA error {rc} at launch")
        return o

    m1["launch_floor_ms"] = cold_graph_ms(launch_empty, (k,), nbytes, l2, 50)
    log(
        f"kernel M1 at [{m}]: every variant equal to the plain version (ripple and edge scalars leading); lanes -> ms: "
        + "; ".join(f"{v['lanes']} {v['ms']:.4f} ({v['ptxas']}; {v['spills']})" for v in out)
        + f"; an empty kernel of {blocks} blocks of {threads} threads, timed the same way: {m1['launch_floor_ms']:.4f} ms"
    )
    return out


def check_kernels(device, sm_clock_hz: float, sms: int) -> tuple[list[dict], list[dict]]:
    import numpy as np
    import torch

    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.golden.field import P, R
    from kzg_rust_tpu_torch.ops import _build
    from kzg_rust_tpu_torch.ops import curve as C
    from kzg_rust_tpu_torch.ops import limbs as L
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    rng = np.random.default_rng(SEED)
    imad_s = sms * IMAD_PER_CLOCK_PER_SM * sm_clock_hz
    l2_bytes = torch.cuda.get_device_properties(device).L2_cache_size
    rows, every = [], []

    def bound(nbytes: float, int_ops: float):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, int_ops / imad_s * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def record(name, kernel, plain, args, source, replaces, nbytes, int_ops, reps, keep=True, plain_reps=2, timed=None):
        """Hold ``kernel`` against ``plain`` on ``args``, time both and return
        the row, kept in ``rows`` unless ``keep`` is false (``every`` keeps
        them all).  ``timed``, when given, is the call timed in place of
        ``kernel`` (the wrapper alone, where ``kernel`` also packs its
        outputs into one tensor for the comparison)."""
        timed = timed or kernel
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        g64 = got.to(torch.int64) & 0xFFFFFFFF
        w64 = want.to(torch.int64) & 0xFFFFFFFF
        err = int((g64 - w64).abs().max().item()) if got.numel() else 0
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain version (max |diff| {err})")
        call_ms = cuda_ms(lambda: timed(*args), reps)
        warm_ms = graph_ms(lambda: timed(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), plain_reps)
        bms, by = bound(nbytes, int_ops)
        # A bytes-bound row is held to the HBM rate, so it is timed on
        # operands the L2 does not hold; replays of one call on the same
        # operands would find them there when they fit twice over.
        cold = by == "bytes" and nbytes < 2 * l2_bytes
        ms = cold_graph_ms(timed, args, nbytes, l2_bytes, reps) if cold else warm_ms
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
            "shape": [int(s) for s in args[0].shape],
            "call_ms": call_ms,
            "l2": "cold" if cold else "as replayed",
        }
        if cold:
            row["ms_l2_warm"] = warm_ms
        log(
            f"kernel {name}: equal to plain at {list(args[0].shape)}; {ms:.4f} ms on the card "
            f"(CUDA graph replay, L2 {row['l2']}{f'; {warm_ms:.4f} ms with the operands in L2' if cold else ''}; "
            f"{call_ms:.4f} ms per call with the host), plain {plain_ms:.2f} ms, bound {bms:.4f} ms by {by}"
        )
        if keep:
            rows.append(row)
        every.append(row)
        return row

    def mont_products(nw):  # 32-bit multiply-adds of one CIOS product: 2 per word product
        return 2 * (2 * nw * nw + nw)

    def mont_squarings(nw):  # of one SOS squaring: cross products and squares, then the reduction
        return 2 * (nw * (nw + 1) // 2 + nw * nw + nw)

    fsrc = "kzg_rust_tpu_torch/csrc/field_kernels.cu"
    csrc = "kzg_rust_tpu_torch/csrc/curve_kernels.cu"
    pk = "kzg_rust_tpu/ops/pallas_kernels.py"
    tpu_line = {"fp": 248, "fr": 252}

    def field_operands(spec, n):
        a = random_field(rng, spec.modulus, n)
        b = random_field(rng, spec.modulus, n)
        a[:3] = [0, spec.modulus - 1, 1]  # edge rows: 0*0, (N-1)^2, 1*x
        b[:2] = [0, spec.modulus - 1]
        return L.to_device(spec, a, device), L.to_device(spec, b, device)

    def product_row(spec, a, b, plain=None, reps=50):
        n, nw = a.shape[0], spec.nwords
        return record(
            f"{'K1' if spec is L.FP else 'K2'} kzg_{spec.name}_mont_mul",
            lambda x, y, s=spec: L.mont_mul(s, x, y),
            plain or (lambda x, y, s=spec: L.mont_mul_plain(s, x, y)),
            (a, b),
            fsrc,
            f"{pk}:{tpu_line[spec.name]}",
            3 * n * nw * 4,
            n * mont_products(nw),
            reps,
            keep=False,
        )

    products = {}
    for spec, n in ((L.FP, SHAPES["fp"]), (L.FR, SHAPES["fr"])):
        a, b = field_operands(spec, n)
        nw = spec.nwords
        products[spec.name] = [product_row(spec, a, b)]
        record(
            f"kzg_{spec.name}_add",
            lambda x, y, s=spec: L.add_mod(s, x, y),
            lambda x, y, s=spec: L.add_mod_plain(s, x, y),
            (a, b),
            fsrc,
            f"kzg_rust_tpu/ops/limbs.py:240 (add_mod, an XLA op)",
            3 * n * nw * 4,
            n * 3 * nw,
            50,
        )
        record(
            f"kzg_{spec.name}_sub",
            lambda x, y, s=spec: L.sub_mod(s, x, y),
            lambda x, y, s=spec: L.sub_mod_plain(s, x, y),
            (a, b),
            fsrc,
            f"kzg_rust_tpu/ops/limbs.py:264 (sub_mod, an XLA op)",
            3 * n * nw * 4,
            n * 3 * nw,
            50,
        )
        bnd = L.to_device(spec, [spec.modulus // 2], device)[0]
        record(
            f"kzg_{spec.name}_cmp",
            lambda x: L.geq_const(spec, x, spec.modulus // 2).to(torch.int32),
            lambda x: L.cmp_plain(x, bnd, 1).to(torch.int32),
            (a,),
            fsrc,
            f"kzg_rust_tpu/ops/limbs.py:299 (geq_const, an XLA op)",
            n * (nw * 4 + 1),
            n * nw,
            50,
        )
    # K2 at the widest launch of the path: the barycentric terms at n = 4096
    # (4096 x 4096 elements, 537 MB an operand), made on the card; the plain
    # version runs in slices of 2^20 rows to bound its int64 scratch.
    n = SHAPES["fr_wide"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    a, b = (torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int32, device=device, generator=gen) for _ in range(2))
    for x in (a, b):
        x[:, 7] &= 0x3FFFFFFF  # below 2^254 < r
    edge_a, edge_b = field_operands(L.FR, 3)
    a[:3], b[:3] = edge_a[:3], edge_b[:3]
    step = 1 << 20
    products["fr"].append(
        product_row(
            L.FR,
            a,
            b,
            lambda x, y: torch.cat([L.mont_mul_plain(L.FR, x[i : i + step], y[i : i + step]) for i in range(0, n, step)]),
            reps=20,
        )
    )
    del a, b
    # The domain sum at a barycentric chunk's (and n = 64's) [4096, 64] and a
    # proof's [4096, 1], one launch each, every term r - 1 in the first
    # column (the largest lazy sum); then captured in a CUDA graph with
    # tickets of its own and replayed twice, the terms changed before each
    # replay and the output zeroed, so that a replay that left the last
    # block's ticket set would write nothing and fail; between the replays
    # a direct sum over more tiles than the graph's (16,384 columns) runs
    # on tickets of its own, which must leave the graph's alone.
    sums = []
    for k, inner in SHAPES["sum"]:
        terms = L.to_device(L.FR, random_field(rng, R, k * inner), device).reshape(k, inner, 8)
        terms[:, 0] = L.FR.const(R - 1, device)
        sums.append(
            record(
                "kzg_fr_sum_rows",
                lambda x, t=L.sum_tickets(inner, device): L.sum_mod(L.FR, x, t),
                lambda x: L.sum_mod_plain(L.FR, x),
                (terms,),
                fsrc,
                "kzg_rust_tpu/ops/limbs.py:482 (sum_mont_redc, an XLA op)",
                terms.numel() * 4 + inner * 8 * 4,
                k * inner * 8,
                50,
            )
        )
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            L.sum_mod(L.FR, terms)
        torch.cuda.current_stream().wait_stream(side)
        tickets = L.sum_tickets(inner, device)
        with _build.capturing(), torch.cuda.graph(graph):
            out = L.sum_mod(L.FR, terms, tickets)
        for replay in range(2):
            terms.copy_(L.to_device(L.FR, random_field(rng, R, k * inner), device).reshape(k, inner, 8))
            out.zero_()
            graph.replay()
            if not torch.equal(out, L.sum_mod_plain(L.FR, terms)):
                raise AssertionError(f"kzg_fr_sum_rows at [{k}, {inner}]: replay {replay + 1} of its CUDA graph disagrees with the plain sum")
            if not torch.equal(tickets, torch.zeros_like(tickets)):
                raise AssertionError(f"kzg_fr_sum_rows at [{k}, {inner}]: replay {replay + 1} left its tickets set")
            if replay == 0:
                wide = L.to_device(L.FR, random_field(rng, R, 2 * 16384), device).reshape(2, 16384, 8)
                if not torch.equal(L.sum_mod(L.FR, wide), L.sum_mod_plain(L.FR, wide)):
                    raise AssertionError("kzg_fr_sum_rows at [2, 16384] between two graph replays disagrees with the plain sum")
        if not torch.equal(L.sum_mod(L.FR, terms), L.sum_mod_plain(L.FR, terms)):
            raise AssertionError(f"kzg_fr_sum_rows at [{k}, {inner}]: a direct launch after the replays disagrees")
        config = L.sum_config(k, inner, sms)
        sums[-1].update(config={"threads": config[0], "pairs": config[1], "row_blocks": config[2]}, graph_replays_equal=2)
        log(f"kernel kzg_fr_sum_rows at [{k}, {inner}]: one launch of {json.dumps(sums[-1]['config'])}; two graph replays on new terms equal the plain sum")
        del graph, out

    # The constant-exponent chains of the path, each one launch, at the
    # widths the path gives them: the square root at n = 4096 and 64 (2 npad
    # points), the Fermat inversion and x^4096 over npad blobs.  Each is
    # held against its plain version and against the same chain as a launch
    # sequence of K1 or K2, which is also timed (CUDA-graph replay and as
    # called).  Edge rows 0, 1 and N - 1 lead every input.
    chains = {}
    chunk = TB.BARY_CHUNK_BLOBS
    pow_chains = (
        [(L.FP, (P + 1) // 4, "(p+1)/4", n) for n in SHAPES["fp_pow"]]
        + [(L.FR, R - 2, "r-2", n) for n in dict.fromkeys((chunk,) + SHAPES["fr_pow"])]
        + [(L.FR, 4096, "4096", chunk)]
    )
    for spec, exponent, label, n in pow_chains:
        nw = spec.nwords
        vals = random_field(rng, spec.modulus, n)
        vals[:3] = [0, 1, spec.modulus - 1]
        x = L.to_device(spec, vals, device)
        digits = L.pow_digits(exponent)
        table, squarings = max(digits) - 1, 4 * (len(digits) - 1)
        mults = table + sum(1 for d in digits[1:] if d)
        kname = "K1" if spec is L.FP else "K2"
        seq = lambda v, s=spec, e=exponent: L.mont_pow_const_plain(s, v, e, mul=L.mont_mul)  # noqa: E731
        got = L.mont_pow_const(spec, x, exponent)
        torch.cuda.synchronize()
        if not torch.equal(got, seq(x)):
            raise AssertionError(f"{kname} chain {label} at [{n}]: disagrees with its launch sequence")
        row = record(
            f"{kname} kzg_{spec.name}_pow_const",
            lambda v, s=spec, e=exponent: L.mont_pow_const(s, v, e),
            lambda v, s=spec, e=exponent: L.mont_pow_const_plain(s, v, e),
            (x,),
            fsrc,
            f"{pk}:{tpu_line[spec.name]}",
            2 * n * nw * 4,
            n * (squarings * mont_squarings(nw) + mults * mont_products(nw)),
            10,
            keep=False,
            plain_reps=1,
        )
        seq_launches = L.LAUNCHES[spec.kernels["mont_mul"]]
        seq(x)
        seq_launches = L.LAUNCHES[spec.kernels["mont_mul"]] - seq_launches
        all_products = squarings + mults
        row.update(
            exponent=label,
            squarings=squarings,
            products=mults,
            all_products_bound_ms=bound(0, n * all_products * mont_products(nw))[0],
            ns_per_dependent_product=row["ms"] * 1e6 / all_products,
            sequence_launches=seq_launches,
            sequence_ms=graph_ms(lambda: seq(x), 2),
            sequence_call_ms=cuda_ms(lambda: seq(x), 2),
        )
        log(
            f"kernel {kname} chain {label} at [{n}]: equal to its {seq_launches}-launch sequence; {squarings} squarings + "
            f"{mults} products in one launch: {row['ms']:.4f} ms ({row['ns_per_dependent_product']:.1f} ns a dependent step) "
            f"against the sequence's {row['sequence_ms']:.4f} ms (CUDA graph) / {row['sequence_call_ms']:.4f} ms (as called); "
            f"bound {row['bound_ms']:.4f} ms, all-products bound {row['all_products_bound_ms']:.4f} ms"
        )
        chains[(spec.name, label, n)] = row

    # K3 with the exception lanes up front, at the subgroup check's first
    # tree level and at stage 2's first level at n = 4096 (the path's widest
    # K3 launch): the 65,536 pairs tiled, Q rotated so every pair differs.
    na, nw = SHAPES["add"]
    pts, base = random_points(rng, na, device)
    q, _ = random_points(rng, na, device)
    g1, g2 = base[0], base[1]
    lanes_p = C.points_to_proj([g1, g2, None, g1], device)
    lanes_q = C.points_to_proj([g1, (g2[0], (-g2[1]) % P), g1, None], device)
    pts[:4] = lanes_p  # P+P, P+(-P), inf+Q, P+inf
    q[:4] = lanes_q
    got = C.proj_add(pts[:4], q[:4])
    from kzg_rust_tpu_torch.golden import curve as gc

    want = [gc.g1_add(g1, g1), None, g1, g1]
    if C.proj_to_points(got.cpu()) != want:
        raise AssertionError("K3: exception lanes disagree with the golden curve")
    reps = -(-nw // na)
    wide_p = pts.repeat(reps, 1, 1)[:nw].contiguous()
    wide_q = torch.cat([q.roll(k, 0) for k in range(reps)])[:nw].contiguous()
    wide_q[:4] = lanes_q
    add_rows = [
        record(
            "K3 kzg_proj_add",
            C.proj_add,
            C.proj_add_plain,
            (a, b),
            csrc,
            f"{pk}:348",
            3 * a.shape[0] * 144,
            a.shape[0] * ADD_PRODUCTS * mont_products(12),
            r,
            keep=False,
        )
        for a, b, r in ((pts, q, 20), (wide_p, wide_q, 5))
    ]

    # K4: one step, and the chain as bases_chain launches it, at stage 1's
    # widths (2 x 4096 and 2 x 64 points).  The chain is held against its
    # plain version and against as many one-step launches.
    steps = 2 * V.NUM_WINDOWS - 1
    dbl_rows = []
    for nd in SHAPES["double"]:
        dbl = pts[:nd].contiguous()
        one = record(
            "K4 kzg_proj_double",
            C.proj_double,
            C.proj_double_plain,
            (dbl,),
            csrc,
            f"{pk}:354",
            2 * nd * 144,
            nd * DOUBLE_PRODUCTS * mont_products(12),
            50,
            keep=False,
        )
        by_steps = torch.empty((steps,) + dbl.shape, dtype=dbl.dtype, device=device)
        cur = dbl
        for k in range(steps):
            cur = C.proj_double(cur, out=by_steps[k])
        chained = C.proj_double_chain(dbl, steps)
        torch.cuda.synchronize()
        if not torch.equal(chained, by_steps):
            raise AssertionError(f"K4 chain at [{nd}]: disagrees with {steps} one-step launches")
        log(f"kernel K4 chain: equal to {steps} one-step K4 launches at [{nd}]")
        chain = record(
            "K4 kzg_proj_double_chain",
            C.proj_double_chain,
            C.proj_double_chain_plain,
            (dbl, steps),
            csrc,
            f"{pk}:354",
            (steps + 1) * nd * 144,
            steps * nd * DOUBLE_PRODUCTS * mont_products(12),
            10,
            keep=False,
        )
        chain["steps"] = steps
        chain["one_step_ms"] = one["ms"]
        chain["one_step_bound_ms"] = one["bound_ms"]
        chain["one_step_plain_ms"] = one["plain_ms"]
        chain["steps_x_one_step_ms"] = steps * one["ms"]
        log(
            f"kernel K4 chain at [{nd}]: {chain['ms']:.4f} ms for {steps} steps in one launch against "
            f"{steps} x {one['ms']:.4f} = {steps * one['ms']:.4f} ms as one-step launches"
        )
        dbl_rows.append(chain)

    # Stage 1's kernels, K5, at its widths (2 x 4096 and 2 x 64 points),
    # the adversarial rows up front, then the distinct rows in turn: A
    # (decompression) and B (the subgroup check over the K4 chain of A's
    # points), each held word for word against its plain version on every
    # row (B's sum keeps the plain version's tree order, so its bits agree
    # on rows that do not decode too) and timed replayed from a CUDA graph;
    # the rows that decode also against the golden model.  Then stage 1
    # whole (A, the chain, B) against its plain version, and its flags on
    # subgroup, off-subgroup and adversarial rows.  A's bound: the square
    # root's squarings and products, and to_mont, x^2, x^3, y^2 and
    # from_mont; B's: SUBGROUP_PRODUCTS.
    s1src = "kzg_rust_tpu_torch/csrc/stage1_kernels.cu"
    vk = "kzg_rust_tpu/ops/verify_kernels.py"
    adversarial, distinct, golden = stage1_rows(random.Random(SEED))
    sqrt_squarings = sum(sq for sq, _ in V.SQRT_CHAIN.steps)
    sqrt_products = V.SQRT_CHAIN.products - sqrt_squarings
    decompress_ops = (sqrt_squarings + 2) * mont_squarings(12) + (sqrt_products + 3) * mont_products(12)
    ptxas = ptxas_report()

    def compressed(rows_):
        return torch.from_numpy(np.frombuffer(b"".join(rows_), np.uint8).reshape(len(rows_), 48).copy()).to(device)

    def packed(points, ok):
        return torch.cat([points.reshape(points.shape[0], -1), ok.to(torch.int32)[:, None]], 1)

    k5 = {"a": [], "b": []}
    for ns in SHAPES["stage1"]:
        rows_s = adversarial + [distinct[k % len(distinct)] for k in range(ns - len(adversarial))]
        comp = compressed(rows_s)
        a = record(
            "K5 kzg_g1_decompress",
            lambda c: packed(*V.g1_uncompress_points(c)),
            lambda c: packed(*V.g1_uncompress_points_plain(c)),
            (comp,),
            s1src,
            f"{vk}:73 (g1_uncompress_points in the XLA program batch_points :212, over {pk}:248)",
            ns * (48 + 144 + 1),
            ns * decompress_ops,
            20,
            keep=False,
            plain_reps=1,
            timed=V.g1_uncompress_points,
        )
        # A's variants, its lanes a point (1 is the one-thread design), each
        # held word for word against the plain version on every row, timed
        # replayed (20 calls in a graph), with ptxas's registers and spills
        # of its kernel.
        want = packed(*V.g1_uncompress_points_plain(comp))
        variants = []
        steps = V.SQRT_CHAIN.products
        for lanes in V.DECOMPRESS_LANES:
            call = lambda c, n_=lanes: V.g1_uncompress_points(c, lanes=n_)  # noqa: E731
            got = packed(*call(comp))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K5 A at [{ns}], {lanes} lanes: disagrees with its plain version")
            ms = graph_ms(lambda c=comp, f=call: f(c), 20)
            block = next(t for t in (128, 64, 32) if -(-ns * lanes // t) >= sms or t == 32)
            _, regs, spills = ptxas.get(f"decompress_kernel {block} {lanes}", (None, "not reported", "not reported"))
            variants.append({"lanes": lanes, "products": steps, "ms": ms, "ns_per_dependent_product": ms * 1e6 / steps, "block": block, "ptxas": regs, "spills": spills})
        a["variants"] = variants
        a["lanes"], a["chain_products"] = V.decompress_lanes(ns, sms), steps
        log(f"kernel K5 A at [{ns}]: every variant equal to the plain version; lanes -> ms: " + "; ".join(f"{v['lanes']} {v['ms']:.4f} ({v['ptxas']}; {v['spills']})" for v in variants))
        points, ok = V.g1_uncompress_points(comp)
        bases, bases2 = V.bases_chain(points)
        b = record(
            "K5 kzg_g1_subgroup_check",
            lambda p, x, y: V.subgroup_check_from_bases(p, x, y).to(torch.int32),
            lambda p, x, y: V.subgroup_check_from_bases_plain(p, x, y).to(torch.int32),
            (points, bases, bases2),
            s1src,
            f"{vk}:166 (subgroup_check_from_bases in the XLA program batch_points :212, over {pk}:248 and :348)",
            ns * (18 * 144 + 1),
            ns * SUBGROUP_PRODUCTS * mont_products(12),
            20,
            keep=False,
            plain_reps=1,
            timed=V.subgroup_check_from_bases,
        )
        # B's variants (lanes an add x groups; 4 x 1 is the serial tree), each
        # held bit for bit against the plain version on every row, timed
        # replayed (20 calls in a graph), with ptxas's registers and spills.
        want_b = V.subgroup_check_from_bases_plain(points, bases, bases2)
        b["variants"] = subgroup_variants(points, bases, bases2, want_b, ns, sms, ptxas)
        b["lanes"] = lanes_label(V.subgroup_lanes(ns, sms))
        log(f"kernel K5 B at [{ns}]: every variant equal to the plain version; lanes an add x groups -> ms: " + "; ".join(f"{v['lanes']} {v['ms']:.4f} ({v['ptxas']}; {v['spills']})" for v in b["variants"]))
        sub = V.subgroup_check_from_bases(points, bases, bases2).cpu().tolist()
        seen = len(adversarial) + min(len(distinct), ns - len(adversarial))
        affine = C.proj_to_points(points[:seen].cpu())
        for i, row in enumerate(rows_s[:seen]):
            decodes, pt, in_sub = golden[row]
            if bool(ok[i]) != decodes or (decodes and (affine[i] != pt or bool(sub[i]) != in_sub)):
                raise AssertionError(f"K5 at [{ns}]: row {i} ({row[:2].hex()}...) disagrees with the golden model")
        got = V.batch_points(comp)
        want = V.batch_points_plain(comp)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"stage 1 at [{ns}]: kernels A, the chain and B disagree with the plain stage")
        stage_ms = graph_ms(lambda c=comp: V.batch_points(c), 10)
        serial_ms = graph_ms(lambda c=comp: V.batch_points(c, lanes=SERIAL_B), 10)
        a["stage1_ms"] = b["stage1_ms"] = stage_ms
        b["stage1_ms_serial_b"] = serial_ms
        log(
            f"kernel K5: A and B equal to their plain versions and the golden model at [{ns}] "
            f"({seen} distinct rows); stage 1 whole equal to its plain version, {stage_ms:.4f} ms replayed "
            f"(A {a['ms']:.4f} + the K4 chain + B {b['ms']:.4f}, B {b['lanes']}); with B's serial tree "
            f"({lanes_label(SERIAL_B)}) {serial_ms:.4f} ms"
        )
        k5["a"].append(a)
        k5["b"].append(b)
    # The flags: all decode and all in the subgroup; all decode, none in it;
    # the adversarial rows, some of which fail each.
    # A valid point without its compression bit does not decode, yet its
    # point is in the subgroup: the fourth case, flag 0 alone cleared.
    ns = SHAPES["stage1"][1]
    uncompressed_bit = bytes([distinct[0][0] & 0x7F]) + distinct[0][1:]
    flag_sets = {
        "subgroup": (distinct[:ns], [1, 1]),
        "off_subgroup": (distinct[256 : 256 + ns], [1, 0]),
        "adversarial": (adversarial + distinct[: ns - len(adversarial)], [0, 0]),
        "undecoded_in_subgroup": (distinct[: ns - 1] + [uncompressed_bit], [0, 1]),
    }
    for label, (rows_s, want) in flag_sets.items():
        comp = compressed(rows_s)
        plain = V.batch_points_plain(comp)[2].tolist()
        for lanes in V.SUBGROUP_LANES:
            flags = V.batch_points(comp, lanes=lanes)[2].tolist()
            if not flags == plain == want:
                raise AssertionError(f"stage 1 flags on the {label} rows, B at lanes {lanes_label(lanes)}: kernels {flags}, plain {plain}, expected {want}")
    log(f"kernel K5: stage 1's flags at [{ns}] in every B variant {[lanes_label(v) for v in V.SUBGROUP_LANES]}: {json.dumps({k: v[1] for k, v in flag_sets.items()})}, as its plain version gives them")
    k5["b"][0]["width_sweep"] = subgroup_width_sweep(device, distinct, sms, ptxas)

    # K1 as the path launches it since stage 1 runs in kernels A and B: the
    # phi halves' X times beta in stage 2, [66, 4096, 3] selected points.
    nbeta = SHAPES["beta"][0] * SHAPES["beta"][1] * SHAPES["beta"][2]
    xs_beta = torch.randint(-(1 << 31), 1 << 31, (nbeta, 12), dtype=torch.int32, device=device, generator=torch.Generator(device=device).manual_seed(SEED))
    xs_beta[:, 11] &= 0x0FFFFFFF  # below 2^380 < p
    beta = L.FP.const(C.BETA_MONT, device)
    k1_path = record(
        "K1 kzg_fp_mont_mul",
        lambda x, y: L.mont_mul(L.FP, x, y),
        lambda x, y: L.mont_mul_plain(L.FP, x, y),
        (xs_beta, beta),
        fsrc,
        f"{pk}:248",
        2 * xs_beta.shape[0] * 48 + 48,
        xs_beta.shape[0] * mont_products(12),
        20,
        keep=False,
        plain_reps=1,
    )
    del xs_beta

    # The prover's MSM kernels at mainnet width.  M1 over one blob's 4096
    # scalars, the edge scalars of tests/test_ops_msm.py leading; M2 over a
    # [26, 16, 4096] table of random canonical words (its arithmetic is the
    # same on any canonical operands; the real table runs in phase 3b, where
    # the vectors check it) with point 5 infinity, on M1's digits, at the
    # configuration the path takes.  M2's work depends on the digits: its
    # bound counts the selections with a nonzero digit and a finite base,
    # 11 products each and 12 in the phi half, and the 96 bytes of table
    # each reads (the bound M2 has always been held to); its second count
    # adds the reduction's A - 1 complete adds of 12 products.
    from kzg_rust_tpu_torch.ops import glv
    from kzg_rust_tpu_torch.ops import msm as M

    msrc = "kzg_rust_tpu_torch/csrc/msm_kernels.cu"
    npts = SHAPES["msm"]
    from kzg_rust_tpu_torch.utils.testing import glv_ripple_scalars

    scalars = random_field(rng, R, npts)
    edge_scalars = [0, 1, R - 1, R // 2, (R + 1) // 2, glv.Z2, R - glv.Z2, glv.LAM] + glv_ripple_scalars()
    scalars[: len(edge_scalars)] = edge_scalars
    k = L.to_device(L.FR, scalars, device)
    m1 = record(
        "M1 kzg_glv_digits",
        M.glv_digits_from_limbs,
        M.glv_digits_plain,
        (k,),
        msrc,
        "kzg_rust_tpu/ops/msm.py:187 (glv_digits_from_limbs, an XLA program)",
        npts * (8 * 4 + 2 * M.GLV_NUM_WINDOWS),
        npts * 2 * (8 * 5 + 4 * 4),
        50,
        keep=False,
    )
    m1["variants"] = glv_digit_variants(k, m1, l2_bytes, ptxas)
    m1["lanes"] = M.GLV_DIGIT_LANES[0]
    digits = M.glv_digits_from_limbs(k)
    check = digits.cpu().to(torch.int64)
    for i in (0, 1, 2, 5, npts - 1):
        v1, v2 = (sum(int(check[h, j, i]) << (5 * j) for j in range(M.GLV_NUM_WINDOWS)) for h in (0, 1))
        if (v1 + v2 * glv.LAM) % R != scalars[i] or max(abs(v1), abs(v2)) >= 1 << 128:
            raise AssertionError(f"M1: the digits of scalar {i} do not recombine to it")
    accs, block = M.msm_config(npts, device)
    table = L.to_device(L.FP, random_field(rng, P, M.GLV_NUM_WINDOWS * M.GLV_NUM_MULTIPLES * npts * 2), device)
    table = table.reshape(M.GLV_NUM_WINDOWS, M.GLV_NUM_MULTIPLES, npts, 2, L.FP.nwords)
    inf = torch.zeros(npts, dtype=torch.bool, device=device)
    inf[5] = True
    ticket = torch.zeros(1, dtype=torch.int32, device=device)
    valid = (digits != 0) & ~inf[None, None]
    selected = [int(valid[h].sum()) for h in (0, 1)]
    selection_ops = (selected[0] * MIXED_PRODUCTS + selected[1] * (MIXED_PRODUCTS + 1)) * mont_products(12)

    def msm_row(a, b):
        return record(
            "M2 kzg_msm_glv",
            lambda t: M.msm_point(t, inf, digits, a, b, ticket),
            lambda t: M.msm_point_plain(t, inf, digits, a, b),
            (table,),
            msrc,
            "kzg_rust_tpu/ops/msm.py:202 (_msm_core_glv with curve.py:350 fold_reduce_mixed, an XLA program)",
            sum(selected) * 96 + digits.numel() + npts + 144,
            selection_ops,
            20,
            keep=False,
            plain_reps=1,
        )

    # The sweep: every configuration held word for word against its plain
    # version and timed from a CUDA graph.  (The random table's entries are
    # not curve points, so the groupings' sums differ; the real points run
    # below and in phase 3b.)
    sweep = []
    for per_sm, b in MSM_SWEEP:
        a = min(sms * per_sm, 2 * M.GLV_NUM_WINDOWS * npts)
        row = msm_row(a, b)
        sweep.append({"accumulators_per_sm": per_sm, "accumulators": a, "block": b, "ms": row["ms"], "call_ms": row["call_ms"]})
    log(f"kernel M2: sweep (accumulators an SM, block) -> ms: {json.dumps(sweep)}")
    m2 = msm_row(accs, block)
    # M2 on all-zero digits takes no selection: its time is the reduction
    # (and the selection loop's bare steps), so the rest is the accumulation.
    no_digits = torch.zeros_like(digits)
    reduction_ms = graph_ms(lambda: M.msm_point(table, inf, no_digits, accs, block, ticket), 20)
    m2.update(
        accumulators=accs,
        block=block,
        selections=sum(selected),
        selections_phi=selected[1],
        selections_per_accumulator=-(-2 * M.GLV_NUM_WINDOWS * npts // accs),
        bound_ms_with_reduction=bound(0, selection_ops + (accs - 1) * ADD_PRODUCTS * mont_products(12))[0],
        reduction_ms=reduction_ms,
        accumulation_ms=m2["ms"] - reduction_ms,
        sweep=sweep,
    )
    log(
        f"kernel M2: {m2['ms']:.4f} ms at {accs} accumulators in blocks of {block}; "
        f"bound {m2['bound_ms']:.4f} ms ({m2['bound_ms'] / m2['ms']:.0%}), with the reduction's adds "
        f"{m2['bound_ms_with_reduction']:.4f} ms ({m2['bound_ms_with_reduction'] / m2['ms']:.0%}); on zero digits (the "
        f"reduction alone) {reduction_ms:.4f} ms, so the accumulation {m2['accumulation_ms']:.4f} ms "
        f"({m2['bound_ms'] / m2['accumulation_ms']:.0%} of the selection bound)"
    )
    m1["at_msm_width"] = npts
    del table

    # M2 on a real table whose second half repeats and negates the first
    # (points 64-95 are 0-31, 96-126 are -(32-62), 63 and 127 infinity) and
    # scalars that repeat with it: at 64 accumulators each mixes points i and
    # i + 64 of one window in turn (P == Q, P == -Q, then adds onto
    # infinity); at 128 (one block) accumulator i is k_i P_i and the tree's
    # first level adds accumulators i and i + 64.  Each kernel point equals
    # its plain version and the golden lincomb.
    from kzg_rust_tpu_torch.golden import curve as gc

    half = 64
    base = [gc.g1_mul(gc.G1_GENERATOR, k + 1) for k in random_field(rng, R - 1, half - 1)] + [None]
    pts = base + base[:32] + [(x, (-y) % P) for x, y in base[32:63]] + [None]
    ks = random_field(rng, R, half)
    ks = ks + ks
    edge = M.MsmContext.build_from_points(pts, device)
    edge_digits = M.glv_digits_from_limbs(L.to_device(L.FR, ks, device))
    want = gc.g1_lincomb_naive(pts, ks)
    total = 2 * M.GLV_NUM_WINDOWS * 2 * half
    for a, b in ((half, 128), (2 * half, 128), (total, 256), (total, 384)):
        got = M.msm_point(edge.table, edge.inf_mask, edge_digits, a, b, edge.ticket)
        plain = M.msm_point_plain(edge.table, edge.inf_mask, edge_digits, a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"M2 at ({a}, {b}) on the repeated and negated points: disagrees with its plain version")
        if C.proj_to_points(got[None].cpu())[0] != want:
            raise AssertionError(f"M2 at ({a}, {b}) on the repeated and negated points: not the lincomb")
    log("kernel M2: equal to its plain version and to the golden lincomb on repeated and negated points (P == Q, P == -Q, infinity)")

    # The mixed add alone, one per accumulator of M2.
    mp, _ = random_points(rng, accs, device)
    mq = L.to_device(L.FP, random_field(rng, P, 2 * accs), device).reshape(accs, 2, L.FP.nwords)
    record(
        "kzg_proj_add_mixed",
        C.proj_add_mixed,
        C.proj_add_mixed_plain,
        (mp, mq),
        msrc,
        "kzg_rust_tpu/ops/curve.py:157 (proj_add_mixed, an XLA op)",
        accs * (144 + 96 + 144),
        accs * MIXED_PRODUCTS * mont_products(12),
        50,
    )

    # The verify path's small launchers.  kzg_fr_sub at every shape the path
    # gives it: the barycentric differences x_b - w_i at a chunk's [4096, 64]
    # (every n = 4096 launch since the evaluation runs in chunks, and
    # n = 64's) and at full width [4096, 4096] (two broadcast operands, a
    # 537 MB result), each in every rows-a-thread variant of the kernel
    # (L.SUB_ROWS; the module's default is the path's), then x^n - 1 over a
    # chunk's [64] and a proof's [4096] - [1] (w - z) and 0 - [4096] (the
    # negated inverses).
    nb = SHAPES["fr_path"]
    xs = L.to_device(L.FR, random_field(rng, R, nb), device)
    roots = L.to_device(L.FR, random_field(rng, R, nb), device)
    xs[:3] = L.to_device(L.FR, [0, R - 1, 1], device)
    roots[:3] = L.to_device(L.FR, [R - 1, 0, 1], device)
    subs = {}
    for label, cols in (("chunk", chunk), ("wide", nb)):
        for rows_per_thread in L.SUB_ROWS:
            row = record(
                "kzg_fr_sub",
                lambda x, w, k=rows_per_thread: L.fr_sub(x[None], w[:, None], k),
                lambda x, w: L.sub_mod_plain(L.FR, x[None], w[:, None]),
                (xs[:cols], roots),
                fsrc,
                "kzg_rust_tpu/ops/limbs.py:264 (sub_mod, an XLA op)",
                (cols + nb) * 32 + nb * cols * 32,
                nb * cols * 3 * 8,
                50 if label == "chunk" else 20,
                keep=False,
                plain_reps=1,
            )
            row.update(rows_per_thread=rows_per_thread, view=[nb, cols])
            subs[(label, rows_per_thread)] = row
        sweep = {k: subs[(label, k)]["ms"] for k in L.SUB_ROWS}
        # What the card's own fill kernel takes to write the same bytes (the
        # difference's bytes are its writes), timed as the row was.
        target = torch.empty((nb, cols, 8), dtype=torch.int32, device=device)
        nbytes = target.numel() * 4
        fill = lambda o: o.fill_(0)  # noqa: E731
        fill_ms = cold_graph_ms(fill, (target,), nbytes, l2_bytes, 20) if nbytes < 2 * l2_bytes else graph_ms(lambda: fill(target), 20)
        subs[(label, L.SUB_ROWS_DEFAULT)]["fill_same_bytes_ms"] = fill_ms
        del target
        log(
            f"kernel kzg_fr_sub at [{nb}, {cols}]: rows a thread -> ms {json.dumps(sweep)}; fastest {min(sweep, key=sweep.get)}, "
            f"the module's {L.SUB_ROWS_DEFAULT}; torch's fill of the same {nbytes} bytes {fill_ms:.4f} ms"
        )
    one, zero = L.FR.const("one_mont", device), L.FR.const("zero", device)
    narrow = {}
    for label, fn, plain, args in (
        ("xn_minus_1", lambda x: L.sub_mod(L.FR, x, one), lambda x: L.sub_mod_plain(L.FR, x, one), (xs[:chunk],)),
        ("proof_w_minus_z", lambda w, z: L.sub_mod(L.FR, w, z[None]), lambda w, z: L.sub_mod_plain(L.FR, w, z[None]), (roots, xs[5])),
        ("proof_neg", lambda v: L.neg_mod(L.FR, v), lambda v: L.sub_mod_plain(L.FR, zero, v), (roots,)),
    ):
        n = args[0].shape[0]
        narrow[label] = record(
            "kzg_fr_sub", fn, plain, args, fsrc, "kzg_rust_tpu/ops/limbs.py:264 (sub_mod, an XLA op)", 2 * n * 32 + 32, n * 3 * 8, 50, keep=False
        )
    sub_row = subs[("chunk", L.SUB_ROWS_DEFAULT)]
    sub_row.update(
        at_full_width=subs[("wide", L.SUB_ROWS_DEFAULT)],
        rows_per_thread_ms={label: {k: subs[(label, k)]["ms"] for k in L.SUB_ROWS} for label in ("chunk", "wide")},
        kernels_line=True,
        **{f"at_{k}": v for k, v in narrow.items()},
    )
    rows.append(sub_row)
    # The generic Fr compare, off the path since the ingest checks the
    # blobs: at the size of the words one chunk's ingest checks.
    wide = torch.randint(-(1 << 31), 1 << 31, (nb * chunk, 8), dtype=torch.int32, device=device, generator=gen)
    wide[:, 7] &= 0x7FFFFFFF  # below 2^255: about half of them at or above r
    mod_r = L.FR.const("mod", device)
    record(
        "kzg_fr_cmp",
        lambda x: L.geq_mod(L.FR, x).to(torch.int32),
        lambda x: L.cmp_plain(x, mod_r, 1).to(torch.int32),
        (wide,),
        fsrc,
        "kzg_rust_tpu/ops/limbs.py:299 (geq_const, an XLA op)",
        nb * chunk * (32 + 1),
        nb * chunk * 8,
        50,
        plain_reps=1,
    )
    rows.append(check_ingest(device, record, cold_ms=lambda fn, args, nbytes: cold_graph_ms(fn, args, nbytes, l2_bytes, 50)))
    # The domain sum at full width and at a chunk (any order of a modular
    # sum gives the same words), and K2 at a chunk's terms.
    for cols in (nb, chunk):
        rows3 = torch.randint(-(1 << 31), 1 << 31, (nb, cols, 8), dtype=torch.int32, device=device, generator=gen)
        rows3[..., 7] &= 0x3FFFFFFF  # below 2^254 < r: canonical terms
        record(
            "kzg_fr_sum_rows",
            lambda x, t=L.sum_tickets(cols, device): L.sum_mod(L.FR, x, t),
            lambda x: L.sum_mod_plain(L.FR, x),
            (rows3,),
            fsrc,
            "kzg_rust_tpu/ops/limbs.py:482 (sum_mont_redc, an XLA op)",
            nb * cols * 32 + cols * 32,
            nb * cols * 8,
            20 if cols == nb else 50,
            plain_reps=1,
        )
    products["fr"].append(product_row(L.FR, rows3.reshape(-1, 8), rows3.reshape(-1, 8).roll(1, 0).contiguous()))
    del wide, rows3
    # kzg_fp_sub at stage 2's widest launch: the negated Y words of the
    # selected digit multiples at n = 4096 (zero minus [66, 4096, 6] words,
    # the zero broadcast).
    ys = torch.randint(-(1 << 31), 1 << 31, SHAPES["neg"] + (12,), dtype=torch.int32, device=device, generator=gen)
    ys[..., 11] &= 0x0FFFFFFF  # below 2^380 < p
    nneg = ys.numel() // 12
    record(
        "kzg_fp_sub",
        lambda y: L.neg_mod(L.FP, y),
        lambda y: L.sub_mod_plain(L.FP, L.FP.const("zero", device), y),
        (ys,),
        fsrc,
        "kzg_rust_tpu/ops/limbs.py:264 (sub_mod, an XLA op)",
        2 * nneg * 48 + 48,
        nneg * 3 * 12,
        20,
        plain_reps=1,
    )
    del ys

    # The kernels line: K1 as the product the path launches (stage 2's
    # beta products), with its product at [8192] and its chain at the square
    # root's widths beside it (the chain's body runs inside kernel A); K2
    # as the chain the path launches, with its products beside it; K3 at
    # the widest launch and K4 as the chain, each with its narrower shape
    # beside it; the K5 kernels A and B at 2 x 4096 points, 2 x 64 beside;
    # M1 and M2.
    k1 = k1_path
    k1["product_8192"] = products["fp"][0]
    k1["chain"] = chains[("fp", "(p+1)/4", SHAPES["fp_pow"][0])]
    k1["chain_at_narrow"] = chains[("fp", "(p+1)/4", SHAPES["fp_pow"][1])]
    k2 = chains[("fr", "r-2", chunk)]
    for n in SHAPES["fr_pow"]:
        if n != chunk:
            k2[f"at_{n}"] = chains[("fr", "r-2", n)]
    k2["x4096"] = chains[("fr", "4096", chunk)]
    k2["product"] = products["fr"]
    k2["product_ms"] = products["fr"][0]["ms"]
    k2["product_bound_ms"] = products["fr"][0]["bound_ms"]
    k2["product_plain_ms"] = products["fr"][0]["plain_ms"]
    add_rows[1]["at_narrow"] = add_rows[0]
    dbl_rows[0]["at_narrow"] = dbl_rows[1]
    for key in ("a", "b"):
        k5[key][0]["at_narrow"] = k5[key][1]
    sums[0]["at_proof"] = sums[1]
    sums[0]["kernels_line"] = True  # redesigned with the K5 A kernel: listed beside the K and M rows
    rows += [k1, k2, add_rows[1], dbl_rows[0], k5["a"][0], k5["b"][0], m1, m2]
    return rows, every


# ---------------------------------------------------------------------------
# Phase 2b: the native host engine against the golden model
# ---------------------------------------------------------------------------

# Encodings each decoder must refuse or read as the golden model does.
G1_ENCODINGS = [
    b"\x00" * 48,
    b"\xc0\x01" + b"\x00" * 46,
    b"\xff" * 48,
    b"\x9f" + b"\xff" * 47,
    b"\x80" + b"\x00" * 47,
    b"\x11" * 48,
]
G2_ENCODINGS = [
    b"\x00" * 96,
    b"\xc0\x01" + b"\x00" * 94,
    b"\xe0" + b"\x00" * 95,
    b"\x9f" + b"\xff" * 95,
    b"\x80" + b"\x00" * 95,
    b"\x80" + b"\x00" * 46 + b"\x01" + b"\x00" * 48,
    b"\x12" * 96,
]


def check_engine(backend, settings) -> dict:
    """Every wrapper of the engine against the golden model on seeded
    inputs, exactly; the median host milliseconds of each side."""
    import hashlib

    from kzg_rust_tpu_torch import hostcrypto, native
    from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
    from kzg_rust_tpu_torch.errors import BadArgs
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.golden import pairing as gp
    from kzg_rust_tpu_torch.golden.field import R

    prng = random.Random(SEED)
    report = {}

    def same(name, engine, golden, inputs):
        """``engine(x) == golden(x)`` for every x, both timed (host clock)."""
        times = {"engine": [], "golden": []}
        for x in inputs:
            got = {}
            for side, fn in (("engine", engine), ("golden", golden)):
                t = time.perf_counter()
                try:
                    got[side] = fn(x)
                except BadArgs as e:  # the class is compared; the engine has one G1 message
                    got[side] = ("BadArgs", str(e) if name.startswith("g2") else "")
                times[side].append((time.perf_counter() - t) * 1e3)
            if got["engine"] != got["golden"]:
                raise AssertionError(f"engine {name}: {got['engine']!r} != golden {got['golden']!r} on {x!r}")
        row = {"cases": len(inputs), **{f"{side}_ms": statistics.median(v) for side, v in times.items()}}
        report[name] = row
        log(f"engine: {name}: equal to golden on {len(inputs)} inputs; median {row['engine_ms']:.4f} ms against golden {row['golden_ms']:.4f} ms")

    data = prng.randbytes(131232)
    same("sha256", lambda n: native.sha256(data[:n]), lambda n: hashlib.sha256(data[:n]).digest(), [0, 1, 55, 56, 63, 64, 65, 127, 128, 1000, 131232])
    g1 = [gc.g1_mul(gc.G1_GENERATOR, prng.randrange(1, R)) for _ in range(8)] + [None]
    g2 = [gc.g2_mul(gc.G2_GENERATOR, prng.randrange(1, R)) for _ in range(3)] + [None] + list(settings.g2_values[:4])
    same("g1_compress", native.g1_compress, gc.g1_compress, g1)
    same("g1_uncompress", native.g1_uncompress, gc.g1_uncompress, [gc.g1_compress(p) for p in g1] + G1_ENCODINGS)
    same("g1_uncompress_batch", native.g1_uncompress_batch, lambda xs: [gc.g1_uncompress(x) for x in xs], [[gc.g1_compress(p) for p in g1]])
    same("g2_uncompress", native.g2_uncompress, gc.g2_uncompress, [gc.g2_compress(q) for q in g2] + G2_ENCODINGS)
    same("g1_in_subgroup", native.g1_in_subgroup, gc.g1_in_subgroup, g1 + [gc.g1_uncompress(out_of_subgroup_compressed(prng))])
    scalars = [0, 1, R - 1, prng.randrange(R), prng.randrange(R)]
    same("g1_mul", lambda a: native.g1_mul(*a), lambda a: gc.g1_mul(*a), [(p, k) for p in g1[:3] + [None] for k in scalars])
    same("g2_mul", lambda a: native.g2_mul(*a), lambda a: gc.g2_mul(*a), [(q, k) for q in g2[:2] for k in scalars[1:4]])
    same("g1_add", lambda a: native.g1_add(*a), lambda a: gc.g1_add(*a), [(g1[0], g1[1]), (g1[0], g1[0]), (g1[0], gc.g1_neg(g1[0])), (None, g1[2])])
    same("g2_add", lambda a: native.g2_add(*a), lambda a: gc.g2_add(*a), [(g2[0], g2[1]), (g2[0], g2[0]), (g2[3], g2[2])])
    lin = [(g1 + [gc.g1_mul(gc.G1_GENERATOR, k) for k in range(2, 9)], [prng.randrange(R) for _ in range(15)] + [R - 1]), ([g1[0]], [5]), ([], [])]
    same("g1_lincomb_naive", lambda a: native.g1_lincomb_naive(*a), lambda a: gc.g1_lincomb_naive(*a), lin)
    a, b = prng.randrange(1, R), prng.randrange(1, R)
    ap, bq, abp = gc.g1_mul(gc.G1_GENERATOR, a), gc.g2_mul(gc.G2_GENERATOR, b), gc.g1_mul(gc.G1_GENERATOR, a * b % R)
    pairs = [
        (abp, gc.G2_GENERATOR, ap, bq),  # true
        (ap, gc.G2_GENERATOR, ap, bq),  # false
        (None, gc.G2_GENERATOR, None, gc.G2_GENERATOR),
        (ap, gc.G2_GENERATOR, None, gc.G2_GENERATOR),
        (ap, None, ap, gc.G2_GENERATOR),
    ]
    if [gp.pairings_verify(*x) for x in pairs[:2]] != [True, False]:
        raise AssertionError("golden pairing: the bilinear pair is not true, or the other not false")
    same("pairings_verify", lambda x: native.pairings_verify(*x), lambda x: gp.pairings_verify(*x), pairs)

    # The barycentric evaluation of four mainnet blobs: the engine's context
    # (one call for all four), the golden backend and the card.
    n = settings.preset.field_elements_per_blob
    evals = [[prng.randrange(R) for _ in range(n)] for _ in range(4)]
    xs = [prng.randrange(R) for _ in evals]
    ctx = hostcrypto.bary_ctx(settings.roots_of_unity)
    t = time.perf_counter()
    ys = ctx.eval_batch(b"".join(e.to_bytes(32, "big") for ev in evals for e in ev), len(evals), xs)
    engine_ms = (time.perf_counter() - t) * 1e3
    golden = GoldenBackend()
    t = time.perf_counter()
    want = [golden.barycentric_eval(settings, ev, x) for ev, x in zip(evals, xs)]
    golden_ms = (time.perf_counter() - t) * 1e3
    card = [backend.barycentric_eval(settings, ev, x) for ev, x in zip(evals, xs)]
    if not ys == want == card:
        raise AssertionError("engine BaryCtx, the golden backend and TorchBackend.barycentric_eval disagree")
    report["bary_ctx"] = {"cases": len(evals), "engine_ms": engine_ms / len(evals), "golden_ms": golden_ms / len(evals)}
    log(f"engine: BaryCtx on {len(evals)} mainnet blobs: equal to golden and to the card's barycentric_eval; {engine_ms / len(evals):.3f} ms a blob against golden {golden_ms / len(evals):.1f} ms")
    return report


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def read_vector(path: str):
    """The vectors' YAML is quoted hex strings and lists of them (flow
    lists in the mainnet sets, block lists in the minimal ones) in, and out
    a quoted string, a list of them, or true/false/null; read with regular
    expressions."""
    with open(path) as fh:
        text = fh.read()
    inp, out = text.split("\noutput:")
    fields = {}
    for m in re.finditer(r"(\w+):\s*(\[[^\]]*\]|'[^']*')", inp):
        strs = re.findall(r"'([^']*)'", m.group(2))
        fields[m.group(1)] = strs if m.group(2).startswith("[") else strs[0]
    for m in re.finditer(r"(?m)^[ \t]+(\w+):[ \t]*\n((?:[ \t]+- '[^']*'[ \t]*(?:\n|$))+)", inp):
        fields[m.group(1)] = re.findall(r"'([^']*)'", m.group(2))
    out = out.strip()
    strs = re.findall(r"'([^']*)'", out)
    if out.startswith(("[", "-")):
        return fields, strs
    return fields, strs[0] if strs else {"true": True, "false": False, "null": None}[out]


def out_of_subgroup_compressed(rng) -> bytes:
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.golden.field import P, fp_sqrt

    while True:
        x = rng.randrange(P)
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return gc.g1_compress((x, y))


def valid_triples() -> list:
    """(blob, commitment, proof) of the six correct-proof
    verify_blob_kzg_proof vectors."""
    from kzg_rust_tpu_torch import Blob, Bytes48

    triples = []
    for f in sorted(glob.glob(os.path.join(ROOT, "tests", "vectors", "verify_blob_kzg_proof", "*", "*correct_proof_*", "data.yaml"))):
        if "incorrect" in f:
            continue
        inp, expected = read_vector(f)
        if expected is not True:
            raise AssertionError(f"{f}: a correct-proof vector that does not verify")
        triples.append((Blob.from_hex(inp["blob"]), Bytes48.from_hex(inp["commitment"]), Bytes48.from_hex(inp["proof"])))
    if len(triples) != 6:
        raise AssertionError(f"expected 6 valid triples, found {len(triples)}")
    return triples


def batches_alone(reps: int = 5) -> dict:
    """The valid batch of each n of BATCH_SIZES (sampled as main_path
    samples them) through ``TorchBackend(time_stages=True)`` on the mainnet
    setup, nothing else: one warm-up batch, then timed_batches over
    ``reps``.  It needs only the package's public calls, so
    ``--batches`` runs it against an older checkout too, in turns with
    this one."""
    import numpy as np

    from kzg_rust_tpu_torch import Kzg
    from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend

    settings = Kzg.load_trusted_setup_file(os.path.join(ROOT, "data", "trusted_setup.txt"))
    backend = TorchBackend(time_stages=True)
    triples = valid_triples()
    nrng = np.random.default_rng(SEED)
    out = {}
    for n in BATCH_SIZES:
        pick = nrng.integers(0, len(triples), size=n)
        args = tuple([triples[i][k] for i in pick] for k in range(3))
        Kzg.verify_blob_kzg_proof_batch(*args, settings, backend)
        out[n] = timed_batches(backend, settings, args, reps=reps)
        out[n]["blobs_per_s"] = n / out[n]["e2e_ms"] * 1e3
        log(f"batches: n={n}: {out[n]['e2e_ms']:.2f} ms median of {reps} ({out[n]['blobs_per_s']:.1f} blobs/s), runs {json.dumps(out[n]['e2e_runs_ms'])}")
    return out


def batch_lanes(triples, pick, sub_point, host: bool = False) -> dict:
    """The five outcome lanes of the batch of ``triples`` at ``pick``, the
    bad row near its end: lane -> ((blobs, commitments, proofs), the
    outcome, or a message the error must hold; with ``host``, the engine's
    message for a malformed point)."""
    from kzg_rust_tpu_torch import Blob, Bytes48
    from kzg_rust_tpu_torch.messages import (
        MSG_INVALID_BYTES32,
        MSG_INVALID_COMPRESSED_G1,
        MSG_MALFORMED_COMMITMENT,
        MSG_NOT_IN_SUBGROUP,
    )

    blobs = [triples[i][0] for i in pick]
    cs = [triples[i][1] for i in pick]
    ps = [triples[i][2] for i in pick]
    bad = len(pick) - BAD_FROM_END
    # A valid proof of another blob (two of the six share the infinity proof).
    swapped = list(ps)
    swapped[bad] = next(t[2] for t in triples if t[2] != ps[bad])
    noncanon = list(blobs)
    noncanon[bad] = Blob(b"\xff" * 32 + bytes(blobs[bad])[32:])
    malformed = list(cs)
    malformed[bad] = Bytes48(b"\x11" * 48)
    nonsub = list(cs)
    nonsub[bad] = sub_point
    return {
        "valid": ((blobs, cs, ps), True),
        "swapped_proof": ((blobs, cs, swapped), False),
        "noncanonical_blob": ((noncanon, cs, ps), MSG_INVALID_BYTES32),
        # The engine names the point (as the JAX package's host path does).
        "malformed_point": ((blobs, malformed, ps), MSG_MALFORMED_COMMITMENT if host else MSG_INVALID_COMPRESSED_G1),
        "non_subgroup_point": ((blobs, nonsub, ps), MSG_NOT_IN_SUBGROUP),
    }


def main_path(backend, settings, host: bool = False) -> dict:
    """The verify path on ``backend``: on the card, or with ``host`` in the
    engine's fused context (``KZG_TORCH_EVAL=host`` set by the caller),
    where no kernel may launch."""
    import numpy as np
    import torch

    from kzg_rust_tpu_torch import Blob, Bytes48, Kzg, KzgError
    from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
    from kzg_rust_tpu_torch.errors import BadArgs
    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.ops import _build
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    golden = GoldenBackend()
    vec = os.path.join(ROOT, "tests", "vectors")
    where = "host placement" if host else "main"

    # The 22 mainnet batch vectors.
    files = sorted(glob.glob(os.path.join(vec, "verify_blob_kzg_proof_batch", "*", "*", "data.yaml")))
    if len(files) != 22:
        raise AssertionError(f"expected 22 batch vectors, found {len(files)}")
    for f in files:
        inp, expected = read_vector(f)
        try:
            got = Kzg.verify_blob_kzg_proof_batch(
                [Blob.from_hex(b) for b in inp["blobs"]],
                [Bytes48.from_hex(c) for c in inp["commitments"]],
                [Bytes48.from_hex(p) for p in inp["proofs"]],
                settings,
                backend,
            )
        except KzgError:
            got = None
        if got != expected:
            raise AssertionError(f"{f}: got {got}, expected {expected}")
    log(f"{where}: all {len(files)} mainnet verify_blob_kzg_proof_batch vectors pass")

    triples = valid_triples()
    nrng = np.random.default_rng(SEED)
    prng = random.Random(SEED)
    sub_point = Bytes48(out_of_subgroup_compressed(prng))
    report = {"lanes": {}, "launches": {}, "stage1_launches": {}, "graph_kernels": {}, "stage_ms": {}, "host_ms": {}, "e2e_ms": {}, "blobs_per_s": {}, "peak_mem_bytes": {}, "peak_reserved_bytes": {}}

    small, large = BATCH_SIZES[0], BATCH_SIZES[-1]
    for n in BATCH_SIZES:
        lanes = batch_lanes(triples, nrng.integers(0, len(triples), size=n), sub_point, host)
        blobs, cs, ps = lanes["valid"][0]
        cross = n == small and not host
        backends = [("torch", backend)] + ([("golden", golden)] if cross else [])
        for lane, (args, expect) in lanes.items():
            for bname, be in backends:
                try:
                    outcome = Kzg.verify_blob_kzg_proof_batch(*args, settings, be)
                except BadArgs as e:
                    outcome = str(e)
                if isinstance(expect, bool):
                    ok = outcome is expect
                else:  # the golden path raises the same class from its own decoder
                    ok = isinstance(outcome, str) and (expect in outcome or bname == "golden")
                if not ok:
                    raise AssertionError(f"{where}: n={n} lane {lane} on {bname}: got {outcome!r}, expected {expect!r}")
            report["lanes"][f"{n}/{lane}"] = "ok" + (" (golden agrees)" if cross else "")
        log(f"{where}: n={n}: the five outcome lanes are right" + (" and agree with the golden backend" if cross else ""))
        if cross:
            report["golden_pairing"] = golden_pairing_lane(backend, settings, lanes)

        # Launch counts of one valid batch: counts set to 0 just before, read
        # just after; those of its stage 1 as the difference across the
        # backend's calls of verify_kernels.batch_points (one a chunk).
        stage1 = report["stage1_launches"][n] = {}
        real_stage1 = V.batch_points

        def counted_stage1(comp):
            before = dict(_build.LAUNCHES)
            out = real_stage1(comp)
            for e, c in _build.LAUNCHES.items():
                if c != before[e]:
                    stage1[e] = stage1.get(e, 0) + c - before[e]
            return out

        V.batch_points = counted_stage1
        try:
            _build.reset_launches()
            valid = Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, backend)
            torch.cuda.synchronize()
        finally:
            V.batch_points = real_stage1
        report["launches"][n] = dict(_build.LAUNCHES)
        if valid is not True:
            raise AssertionError(f"{where}: n={n}: the valid batch did not verify")
        if host and any(report["launches"][n].values()):
            raise AssertionError(f"host placement launched kernels: {report['launches'][n]}")
        log(f"{where}: n={n}: launches in one valid batch: {json.dumps({e: c for e, c in report['launches'][n].items() if c})}")
        pipe = settings._device_cache.get(("bary_chunks", str(backend.device), TB.BARY_CHUNK_BLOBS))
        if pipe is not None and pipe.graph is not None and not host:
            report["graph_kernels"][pipe.graph.name] = pipe.graph.kernels

        if not host and npad_of(n) >= 2 * TB.BARY_CHUNK_BLOBS:
            report.setdefault("chunked_equals_full", {})[n] = chunked_equals_full(backend, settings, lanes, npad_of(n))

        # Stage times and end to end, median of 3 runs.  On the card the
        # allocator's cache is emptied first, and one untimed batch refills
        # it, so that the peak counts the path alone and the timed runs take
        # no new segments.
        if not host:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, backend)
        runs = timed_batches(backend, settings, (blobs, cs, ps), host)
        report["e2e_ms"][n] = runs["e2e_ms"]
        report.setdefault("e2e_runs_ms", {})[n] = runs["e2e_runs_ms"]
        report["blobs_per_s"][n] = n / (report["e2e_ms"][n] / 1e3)
        if host:
            log(f"{where}: n={n}: end to end {report['e2e_ms'][n]:.1f} ms = {report['blobs_per_s'][n]:.1f} blobs/s (host clock, median of 3)")
            continue
        report["stage_ms"][n] = runs["stage_ms"]
        report["host_ms"][n] = runs["host_ms"]
        log(
            f"main: n={n}: stage1 {report['stage_ms'][n]['stage1']:.2f} ms, bary "
            f"{report['stage_ms'][n]['bary']:.2f} ms, stage2 {report['stage_ms'][n]['stage2']:.2f} ms "
            f"(CUDA events, median of 3); end to end {report['e2e_ms'][n]:.1f} ms = "
            f"{report['blobs_per_s'][n]:.1f} blobs/s (host clock, median of 3)"
        )
        log(f"main: n={n}: host ms between steps (median of 3; the pairing in the engine): {json.dumps(report['host_ms'][n])}")
        report["peak_mem_bytes"][n] = torch.cuda.max_memory_allocated()
        report["peak_reserved_bytes"][n] = torch.cuda.max_memory_reserved()
        log(
            f"main: n={n}: peak device memory over the 4 runs: {report['peak_mem_bytes'][n]} bytes allocated, "
            f"{report['peak_reserved_bytes'][n]} reserved" + (f" (cap {PEAK_MEM_CAP})" if n == large else "")
        )
        if n == large:
            if report["peak_reserved_bytes"][n] > PEAK_MEM_CAP:
                raise AssertionError(f"n={n}: peak reserved device memory {report['peak_reserved_bytes'][n]} above the cap {PEAK_MEM_CAP}")
            report["replay_equals_direct"] = replay_equals_direct(backend, settings, blobs, cs)
            report["replay_kernels"] = replay_kernels()
            report["staging_alone"] = staging_alone(backend, settings, blobs)
            report["sweeps"] = width_sweeps(backend, settings, (blobs, cs, ps))
            report["trace"] = profile_batch(backend, settings, (blobs, cs, ps))
            report["beside_engine_threads"] = beside_engine_threads(backend, settings, lanes)
    return report


def npad_of(n: int) -> int:
    """The backend's padded batch size: a power of two, at least 4."""
    return max(4, 1 << (n - 1).bit_length())


def batch_launches(npad: int) -> dict:
    """The launches of one valid batch of padded size ``npad`` under the
    port's chunk widths, by part; a replay of the barycentric graph counts
    one (its kernels: ``_build.Graph.kernels``)."""
    from kzg_rust_tpu_torch.backends import torch_backend as TB

    s1 = TB.STAGE1_CHUNK_BLOBS
    replays = npad // TB.BARY_CHUNK_BLOBS if npad >= 2 * TB.BARY_CHUNK_BLOBS else 0
    trees = (132 * npad - 1).bit_length() + (264 * npad - 1).bit_length() + 6 + 1
    parts = {
        "stage1": 3 * (npad // s1 if npad >= 2 * s1 else 1),
        "bary": 0 if replays else BARY_LAUNCHES,
        "graph:bary_chunk": replays,
        "stage2": 3 + 1 + trees,
    }
    return parts | {"total": sum(parts.values())}


def timed_batches(backend, settings, args, host: bool = False, reps: int = 3) -> dict:
    """End to end (host clock) and, on the card, stage times (CUDA events)
    and host laps of ``reps`` valid batches, each the median."""
    import torch

    from kzg_rust_tpu_torch import Kzg

    stages, e2e, steps = {}, [], {}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        valid = Kzg.verify_blob_kzg_proof_batch(*args, settings, backend)
        e2e.append((time.perf_counter() - t) * 1e3)
        if valid is not True:
            raise AssertionError(f"n={len(args[0])}: the valid batch did not verify")
        if not host:
            for s, v in backend.stage_ms().items():
                stages.setdefault(s, []).append(v)
            for s, v in backend.host_ms.items():
                steps.setdefault(s, []).append(v)
    med = lambda d: {k: statistics.median(v) for k, v in d.items()}  # noqa: E731
    return {"e2e_ms": statistics.median(e2e), "e2e_runs_ms": e2e, "stage_ms": med(stages), "host_ms": med(steps)}


def chunked_equals_full(backend, settings, lanes, npad: int) -> dict:
    """Every lane once in the chunked regime and once with both chunk widths
    patched to ``npad`` (the full-width path): the same outcome, and the
    same words in the packed fetch (both flags, the blob flag, every y)."""
    import numpy as np

    from kzg_rust_tpu_torch import Kzg
    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.errors import BadArgs

    widths = (TB.BARY_CHUNK_BLOBS, TB.STAGE1_CHUNK_BLOBS)
    fetched = []
    real = backend._fetch

    def recording(*parts):
        fetched.append(real(*parts))
        return fetched[-1]

    backend._fetch = recording
    out = {}
    try:
        for lane, (args, _) in lanes.items():
            got = []
            for bary, stage1 in (widths, (npad, npad)):
                TB.BARY_CHUNK_BLOBS, TB.STAGE1_CHUNK_BLOBS = bary, stage1
                try:
                    got.append(Kzg.verify_blob_kzg_proof_batch(*args, settings, backend))
                except BadArgs as e:
                    got.append(str(e))
            if got[0] != got[1] or not np.array_equal(fetched[-2], fetched[-1]):
                raise AssertionError(f"n={len(args[0])} lane {lane}: chunked {got[0]!r} against full width {got[1]!r}, or their fetched words differ")
            out[lane] = {"outcome": got[0], "words": int(fetched[-1].size)}
    finally:
        TB.BARY_CHUNK_BLOBS, TB.STAGE1_CHUNK_BLOBS = widths
        del backend._fetch
    log(f"main: n={len(args[0])}: each lane chunked (widths {widths}) and at full width: the same outcome and the same fetched words (flags and {out['valid']['words'] - 3} y words)")
    return out


def replay_equals_direct(backend, settings, blobs, cs) -> dict:
    """One replay of the barycentric graph on the batch's first chunk
    against the same chunk launched directly, word for word, and both
    times (the replay from the graph, the direct call as launched)."""
    import numpy as np
    import torch

    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.ops import limbs as L
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    width = TB.BARY_CHUNK_BLOBS
    ctx = backend._fr_ctx(settings)
    pipe = backend._bary_pipe(settings, ctx, width)
    chunk = blobs[:width]
    zs = TB._Challenges(settings.preset, chunk, cs[:width]).get(0, width)
    blob_in = torch.from_numpy(np.frombuffer(b"".join(bytes(b) for b in chunk), np.uint8).reshape(pipe.blob_in.shape).copy()).cuda()
    xs_in = torch.from_numpy(L.ints_to_words(L.FR.nwords, zs)).cuda()
    pipe.blob_in.copy_(blob_in)
    pipe.xs_in.copy_(xs_in)
    pipe.graph.replay()
    ys, ok = (t.clone() for t in pipe.graph.outputs)
    want_ys, want_ok = V.bary_batch_from_bytes(ctx, blob_in, xs_in)
    torch.cuda.synchronize()
    if not (torch.equal(ys, want_ys) and torch.equal(ok, want_ok) and bool(ok)):
        raise AssertionError("the barycentric graph's replay disagrees with the same chunk launched directly")
    out = {
        "width": width,
        "kernels_in_graph": pipe.graph.kernels,
        "replay_ms": cuda_ms(pipe.graph.graph.replay, 10),
        "direct_ms": cuda_ms(lambda: V.bary_batch_from_bytes(ctx, blob_in, xs_in), 10),
    }
    log(
        f"main: one replay of the barycentric graph at {width} blobs equals the same chunk launched directly, word for word; "
        f"replay {out['replay_ms']:.4f} ms, direct {out['direct_ms']:.4f} ms (CUDA events, median of 10); "
        f"{sum(out['kernels_in_graph'].values())} kernels a replay: {json.dumps(out['kernels_in_graph'])}"
    )
    return out


def staging_alone(backend, settings, blobs) -> dict:
    """The chunked path's host staging with nothing else running: every
    chunk of ``blobs`` waited for, copied into its pinned staging buffer and
    its upload enqueued, then one synchronize (host clock; the copies' rate
    beside the batch's ``stage_chunk_copy`` lap, where the hash pool runs
    beside them)."""
    import torch

    from kzg_rust_tpu_torch.backends import torch_backend as TB

    width = TB.BARY_CHUNK_BLOBS
    pipe = backend._bary_pipe(settings, backend._fr_ctx(settings), width)
    times = []
    with pipe.lock:
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for k, s in enumerate(range(0, len(blobs), width)):
                pipe.wait(k)
                pipe.stage(k, blobs[s : s + width])
            copied = time.perf_counter()
            torch.cuda.synchronize()
            times.append(((copied - t) * 1e3, (time.perf_counter() - t) * 1e3))
    nbytes = sum(len(b) for b in blobs)
    out = {"copy_ms": statistics.median(c for c, _ in times), "with_uploads_ms": statistics.median(u for _, u in times), "bytes": nbytes}
    out["copy_gb_per_s"] = nbytes / out["copy_ms"] / 1e6
    log(
        f"main: n={len(blobs)}: staging alone (no hashing beside it): {nbytes} bytes copied into the pinned buffers in "
        f"{out['copy_ms']:.1f} ms ({out['copy_gb_per_s']:.2f} GB/s), {out['with_uploads_ms']:.1f} ms to the last upload's end (host clock, median of 3)"
    )
    return out


def width_sweeps(backend, settings, args, rounds: int = 3) -> dict:
    """The two chunk widths at this n: the BARY_SWEEP widths, then the
    STAGE1_SWEEP widths (the other at the module's value).  Each width
    runs one warm-up batch, then ``rounds`` rounds each run one batch of
    every width in turn, so that the host's drift falls on all of them
    alike; a width's figures are the medians over the rounds.  Chunked
    stage 1 is held word for word against full width, and each bary
    width's graph replay is timed alone.  The other widths' chunk
    pipelines are freed afterwards."""
    import numpy as np
    import torch

    from kzg_rust_tpu_torch import Kzg
    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    blobs, cs, ps = args
    npad = npad_of(len(blobs))
    widths = (TB.BARY_CHUNK_BLOBS, TB.STAGE1_CHUNK_BLOBS)
    rows = b"".join(bytes(c) + bytes(p) for c, p in zip(cs, ps)) + (b"\xc0" + b"\x00" * 47) * (2 * (npad - len(blobs)))
    comp = torch.from_numpy(np.frombuffer(rows, np.uint8).reshape(2 * npad, 48).copy()).to(backend.device)
    full = V.batch_points(comp)

    def set_width(part, w):
        if part == "bary":
            TB.BARY_CHUNK_BLOBS = w
        else:
            TB.STAGE1_CHUNK_BLOBS = npad if w == "full" else w

    def sweep(part, values):
        runs = {w: [] for w in values}
        for w in values:
            set_width(part, w)
            if part == "stage1":
                got = backend._stage1(comp, npad)
                torch.cuda.synchronize()
                if not all(torch.equal(g, f) for g, f in zip(got, full)):
                    raise AssertionError(f"stage 1 in chunks of {w} blobs disagrees with full width")
                del got
            Kzg.verify_blob_kzg_proof_batch(*args, settings, backend)
        for _ in range(rounds):
            for w in values:
                set_width(part, w)
                runs[w].append(timed_batches(backend, settings, args, reps=1))
        set_width(part, widths[part == "stage1"])
        med = lambda key, rs: {k: statistics.median(r[key][k] for r in rs) for k in rs[0][key]}  # noqa: E731
        return {
            w: {"e2e_ms": statistics.median(r["e2e_ms"] for r in rs), "e2e_runs_ms": [r["e2e_ms"] for r in rs], "stage_ms": med("stage_ms", rs), "host_ms": med("host_ms", rs)}
            for w, rs in runs.items()
        }

    try:
        out = {"bary": sweep("bary", BARY_SWEEP), "stage1": sweep("stage1", STAGE1_SWEEP)}
        if backend.device.type == "cuda":
            for w, r in out["bary"].items():
                r["replay_ms"] = cuda_ms(backend._bary_pipe(settings, backend._fr_ctx(settings), w).graph.graph.replay, 10)
                r["replays_ms"] = r["replay_ms"] * (npad // w)
    finally:
        TB.BARY_CHUNK_BLOBS, TB.STAGE1_CHUNK_BLOBS = widths
        for key in [k for k in settings._device_cache if k[0] == "bary_chunks" and k[2] != widths[0]]:
            del settings._device_cache[key]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for part, runs in out.items():
        best = min(runs, key=lambda w: runs[w]["e2e_ms"])
        keep = ("e2e_ms", "replay_ms", "replays_ms")
        summary = {str(w): {k: r[k] for k in keep if k in r} | {"stage1_ms": r["stage_ms"]["stage1"], "bary_ms": r["stage_ms"]["bary"]} for w, r in runs.items()}
        log(
            f"sweep: n={len(blobs)}: {part} chunk width -> median of {rounds} rounds, the widths in turn (host clock e2e, CUDA-event "
            f"stages; a bary width's replay alone, median of 10, and times the chunks): {json.dumps(summary)}; best {best}, the module's {widths[part == 'stage1']}"
        )
    return out


def replay_kernels(reps: int = 3) -> dict:
    """One barycentric chunk graph (``_BaryChunks``, BARY_CHUNK_BLOBS
    random canonical mainnet blobs, made on the card from SEED) replayed
    ``reps`` times under torch.profiler: every device operation a replay
    runs, by name (count a replay, mean microseconds), and their total,
    beside the port's own launches in the graph (``Graph.kernels``) and the
    replay's time (CUDA events, median of 10).  It needs only what the
    package has had since its chunked pipeline, so ``--replay-kernels``
    runs it against an older checkout too."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kzg_rust_tpu_torch.backends import torch_backend as TB
    from kzg_rust_tpu_torch.golden.field import R
    from kzg_rust_tpu_torch.ops import limbs as L
    from kzg_rust_tpu_torch.ops import protocol_kernels as PK
    from kzg_rust_tpu_torch.presets import MAINNET
    from kzg_rust_tpu_torch.utils.domain import compute_roots_of_unity

    device = torch.device("cuda", 0)
    fe = MAINNET.field_elements_per_blob
    settings = types.SimpleNamespace(preset=MAINNET, roots_of_unity=compute_roots_of_unity(fe.bit_length() - 1))
    width = TB.BARY_CHUNK_BLOBS
    pipe = TB._BaryChunks(PK.FrContext.build(settings, device), device, width, fe)
    gen = torch.Generator(device=device).manual_seed(SEED)
    pipe.blob_in.copy_(torch.randint(0, 256, tuple(pipe.blob_in.shape), dtype=torch.uint8, device=device, generator=gen))
    pipe.blob_in[..., 0] &= 0x3F  # below 2^254 < r
    pipe.xs_in.copy_(L.to_device(L.FR, random_field(np.random.default_rng(SEED), R, width), device))
    pipe.graph.replay()
    torch.cuda.synchronize()
    if not bool(pipe.graph.outputs[1]):
        raise AssertionError("replay_kernels: canonical blobs read as not canonical")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            pipe.graph.graph.replay()
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "trace_replay.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
    by_name = {}
    for e in events:
        count, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (count + 1, us + e["dur"])
    out = {
        "width": width,
        "device_ops_a_replay": len(events) / reps,
        "by_name": {k: {"a_replay": c / reps, "mean_us": us / c} for k, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])},
        "port_launches_a_replay": sum(pipe.graph.kernels.values()),
        "replay_ms": cuda_ms(pipe.graph.graph.replay, 10),
    }
    log(
        f"replay: one barycentric graph at {width} blobs runs {out['device_ops_a_replay']:g} device operations (torch.profiler, {reps} replays), "
        f"{out['port_launches_a_replay']} of them the port's launches; replay {out['replay_ms']:.4f} ms (CUDA events, median of 10); "
        f"by name: {json.dumps(out['by_name'])}"
    )
    return out


def profile_batch(backend, settings, args) -> dict:
    """One batch under torch.profiler: the device's operations summed by
    name (top 12), the share of host-to-device copy time that overlaps a
    kernel, and the device's busy share of the batch (from the trace's
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kzg_rust_tpu_torch import Kzg

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        Kzg.verify_blob_kzg_proof_batch(*args, settings, backend)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    path = os.path.join(ROOT, "build", f"trace_n{len(args[0])}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        log("trace: torch.profiler recorded no device events; the device's operations are not measured")
        return {"device_events": 0}

    def merged(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def overlap(span, union):
        return sum(max(0.0, min(span[1], b) - max(span[0], a)) for a, b in union)

    kernels = merged([(e["ts"], e["ts"] + e["dur"]) for e in events if e["cat"] == "kernel"])
    h2d = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    h2d_us = sum(b - a for a, b in h2d)
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_us = sum(b - a for a, b in merged([(e["ts"], e["ts"] + e["dur"]) for e in events]))
    out = {
        "device_events": len(events),
        "top_ms": {k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]},
        "h2d_ms": h2d_us / 1e3,
        "h2d_copies": len(h2d),
        "h2d_overlapped_share": sum(overlap(s, kernels) for s in h2d) / h2d_us if h2d_us else None,
        "device_busy_ms": busy_us / 1e3,
        "wall_ms": wall_us / 1e3,
        "device_busy_share": busy_us / wall_us,
    }
    log(
        f"trace: n={len(args[0])}: {len(events)} device events; H2D {out['h2d_ms']:.2f} ms in {len(h2d)} copies, "
        f"{out['h2d_overlapped_share'] if out['h2d_overlapped_share'] is None else round(out['h2d_overlapped_share'], 4)} of it beside a kernel; "
        f"device busy {out['device_busy_ms']:.2f} of {out['wall_ms']:.1f} ms (host clock, under the profiler); top device ops (ms): {json.dumps(out['top_ms'])}"
    )
    return out


def golden_pairing_lane(backend, settings, lanes) -> dict:
    """The valid and swapped-proof batches on the card, with the pairing
    inputs the backend hands the engine put through the pure-Python pairing
    too: the same answer, and both times (host clock)."""
    from kzg_rust_tpu_torch import Kzg
    from kzg_rust_tpu_torch.golden import pairing as gp

    seen = []
    engine = backend.pairings_verify

    def recording(*args):
        t = time.perf_counter()
        ok = engine(*args)
        seen.append((args, ok, (time.perf_counter() - t) * 1e3))
        return ok

    backend.pairings_verify = recording
    try:
        for lane in ("valid", "swapped_proof"):
            args, expect = lanes[lane]
            if Kzg.verify_blob_kzg_proof_batch(*args, settings, backend) is not expect:
                raise AssertionError(f"golden-pairing lane {lane}: the batch did not give {expect}")
    finally:
        del backend.pairings_verify
    report = {"engine_ms": [], "golden_ms": [], "results": []}
    for (args, ok, _), lane in zip(seen, ("valid", "swapped_proof")):
        RECORDED_PAIRINGS.append((f"n={BATCH_SIZES[0]} {lane}", args, ok, lanes[lane][1]))
    for args, ok, ms in seen:
        t = time.perf_counter()
        want = gp.pairings_verify(*args)
        report["golden_ms"].append((time.perf_counter() - t) * 1e3)
        report["engine_ms"].append(ms)
        report["results"].append(ok)
        if want is not ok:
            raise AssertionError(f"the engine's pairing gave {ok}, the pure-Python pairing {want}")
    if report["results"] != [True, False]:
        raise AssertionError(f"golden-pairing lane: pairings {report['results']}, expected [True, False]")
    log(f"main: n={BATCH_SIZES[0]}: the pairing inputs of the valid and swapped batches give {report['results']} in the engine ({report['engine_ms'][0]:.2f} / {report['engine_ms'][1]:.2f} ms) and in the pure-Python pairing ({report['golden_ms'][0]:.1f} / {report['golden_ms'][1]:.1f} ms)")
    return report


def beside_engine_threads(backend, settings, lanes) -> dict:
    """The valid and swapped-proof batches on the card (the host hashing in
    the port's SHA-256 pool) while other threads verify them in the engine's
    fused context (its own threads, the GIL dropped): every answer right."""
    import threading

    from kzg_rust_tpu_torch import Kzg

    ctx = backend._verify_native_ctx(settings)
    runs = {lane: lanes[lane] for lane in ("valid", "swapped_proof")}
    got, errors, stop = [], [], threading.Event()

    def engine_loop(lane):
        (blobs, cs, ps), _ = runs[lane]
        comms, proofs = b"".join(bytes(c) for c in cs), b"".join(bytes(p) for p in ps)
        try:
            while not stop.is_set():
                got.append((lane, ctx.verify_scatter(blobs, len(blobs), comms, proofs)))
        except Exception as e:  # reported after the join
            errors.append(e)

    threads = [threading.Thread(target=engine_loop, args=(lane,)) for lane in runs]
    for t in threads:
        t.start()
    try:
        card = []
        for _ in range(2):
            for lane, (args, expect) in runs.items():
                card.append((lane, Kzg.verify_blob_kzg_proof_batch(*args, settings, backend)))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"engine threads beside the card: alive {[t.is_alive() for t in threads]}, errors {errors}")
    want = {lane: expect for lane, (_, expect) in runs.items()}
    wrong = [(lane, ok) for lane, ok in card + got if ok is not want[lane]]
    if wrong or not got:
        raise AssertionError(f"batches beside the engine's threads: wrong answers {wrong[:4]}, {len(got)} engine runs")
    log(f"main: n={len(runs['valid'][0][0])}: {len(card)} card batches beside {len(got)} engine verifications of the same batches on {len(threads)} threads: every answer right")
    return {"card_batches": len(card), "engine_batches": len(got)}


# ---------------------------------------------------------------------------
# Phase 3b: the prover path
# ---------------------------------------------------------------------------


def prover_vectors(backend, settings, where: str) -> dict:
    """Every mainnet vector of the four single-blob calls; kind -> count."""
    from kzg_rust_tpu_torch import Blob, Bytes32, Bytes48, Kzg, KzgError

    vec = os.path.join(ROOT, "tests", "vectors")

    def hexed(x) -> str:
        return "0x" + bytes(x).hex()

    calls = {
        "blob_to_kzg_commitment": lambda f: hexed(Kzg.blob_to_kzg_commitment(Blob.from_hex(f["blob"]), settings, backend)),
        "compute_kzg_proof": lambda f: [hexed(x) for x in Kzg.compute_kzg_proof(Blob.from_hex(f["blob"]), Bytes32.from_hex(f["z"]), settings, backend)],
        "compute_blob_kzg_proof": lambda f: hexed(Kzg.compute_blob_kzg_proof(Blob.from_hex(f["blob"]), Bytes48.from_hex(f["commitment"]), settings, backend)),
        "verify_blob_kzg_proof": lambda f: Kzg.verify_blob_kzg_proof(Blob.from_hex(f["blob"]), Bytes48.from_hex(f["commitment"]), Bytes48.from_hex(f["proof"]), settings, backend),
    }
    counts = {}
    for kind, count in PROVER_VECTORS.items():
        files = sorted(glob.glob(os.path.join(vec, kind, "*", "*", "data.yaml")))
        if len(files) != count:
            raise AssertionError(f"expected {count} {kind} vectors, found {len(files)}")
        for f in files:
            inp, expected = read_vector(f)
            try:
                got = calls[kind](inp)
            except KzgError:
                got = None
            if got != expected:
                raise AssertionError(f"{where}: {f}: got {got}, expected {expected}")
        counts[kind] = count
        log(f"{where}: all {count} mainnet {kind} vectors pass")
    return counts


def prover_blob(settings):
    """The blob of a valid ``blob_to_kzg_commitment`` vector with the most
    distinct elements, and its commitment."""
    from kzg_rust_tpu_torch import Blob, Bytes48

    files = sorted(glob.glob(os.path.join(ROOT, "tests", "vectors", "blob_to_kzg_commitment", "*", "*_valid_*", "data.yaml")))
    cases = [read_vector(f) for f in files]
    n = settings.preset.field_elements_per_blob
    inp, commitment = max(cases, key=lambda c: len(set(bytes.fromhex(c[0]["blob"][2:])[i : i + 32] for i in range(0, n * 32, 32))))
    return Blob.from_hex(inp["blob"]), Bytes48.from_hex(commitment)


def prover_calls(backend, settings, blob, commitment) -> dict:
    """The timed single-blob calls: a commit, a proof with z out of the
    domain and at roots[7], a blob proof, and the blob proof's verification."""
    from kzg_rust_tpu_torch import Bytes32, Bytes48, Kzg

    z_out = Bytes32((0x5EED).to_bytes(32, "big"))
    z_in = Bytes32(settings.roots_of_unity[7].to_bytes(32, "big"))
    calls = {
        "commit": lambda: Kzg.blob_to_kzg_commitment(blob, settings, backend),
        "proof": lambda: Kzg.compute_kzg_proof(blob, z_out, settings, backend),
        "proof_in_domain": lambda: Kzg.compute_kzg_proof(blob, z_in, settings, backend),
        "blob_proof": lambda: Kzg.compute_blob_kzg_proof(blob, commitment, settings, backend),
    }
    blob_proof = Bytes48(bytes(calls["blob_proof"]()))
    calls["verify_blob"] = lambda: Kzg.verify_blob_kzg_proof(blob, commitment, blob_proof, settings, backend)
    if calls["verify_blob"]() is not True:
        raise AssertionError("verify_blob_kzg_proof rejects the blob proof the prover made")
    return calls


def verify_blob_steps(backend, settings, blob, commitment, proof) -> dict:
    """``verify_blob_kzg_proof`` on the card as the protocol runs it, step
    by step: host-clock milliseconds of each (median of 3, the card
    synchronised after each)."""
    import torch

    from kzg_rust_tpu_torch import protocol
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.utils import bls_serde as serde

    c = serde.bytes_to_kzg_commitment(commitment)
    evals = protocol.blob_to_polynomial(settings, blob)
    z = serde.challenge_hash(settings.preset, blob, commitment)
    y = protocol.evaluate_polynomial_in_evaluation_form(settings, evals, z, backend)
    pt = serde.bytes_to_kzg_proof(proof)
    x_g2 = backend.g2_mul(gc.G2_GENERATOR, z)
    steps = {
        "decode_and_check_commitment": lambda: serde.bytes_to_kzg_commitment(commitment),
        "blob_to_polynomial": lambda: protocol.blob_to_polynomial(settings, blob),
        "challenge": lambda: serde.challenge_hash(settings.preset, blob, commitment),
        "evaluation_upload": lambda: backend._fr_words(evals),
        "evaluation": lambda: protocol.evaluate_polynomial_in_evaluation_form(settings, evals, z, backend),
        "decode_and_check_proof": lambda: serde.bytes_to_kzg_proof(proof),
        "g2_mul": lambda: backend.g2_mul(gc.G2_GENERATOR, z),
        "g1_mul": lambda: backend.g1_mul(gc.G1_GENERATOR, y),
        "pairing": lambda: backend.pairings_verify(c, gc.G2_GENERATOR, pt, x_g2),
        "pairing_equation": lambda: protocol.verify_kzg_proof_impl(settings, c, z, y, pt, backend),
    }
    if protocol.verify_kzg_proof_impl(settings, c, z, y, pt, backend) is not True:
        raise AssertionError("verify_blob_kzg_proof steps: the pairing equation does not hold")
    out = {}
    for name, fn in steps.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = statistics.median(times)
    return out


def prover_path(backend, settings) -> dict:
    import torch

    from kzg_rust_tpu_torch import Bytes32, Kzg
    from kzg_rust_tpu_torch.ops import _build

    report = {"launches": {}, "host_ms": {}, "stage_ms": {}}

    # The MSM table, built at the backend's first use.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    a.record()
    ctx = backend._msm_ctx(settings)
    b.record()
    b.synchronize()
    report["table"] = {
        "host_ms": (time.perf_counter() - t) * 1e3,
        "device_ms": a.elapsed_time(b),
        "bytes": ctx.table.numel() * ctx.table.element_size() + ctx.inf_mask.numel(),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "peak_above_before_bytes": torch.cuda.max_memory_allocated() - before,
        "accumulators": ctx.accumulators,
        "block": ctx.block,
        "shape": list(ctx.table.shape),
    }
    log(f"prover: MSM table {report['table']['shape']} ({report['table']['bytes']} bytes) built in {report['table']['host_ms']:.1f} ms host clock, {report['table']['device_ms']:.1f} ms between CUDA events; peak {report['table']['peak_mem_bytes']} bytes ({report['table']['peak_above_before_bytes']} above what was allocated before); M2 takes {ctx.accumulators} accumulators in blocks of {ctx.block}")

    report["vectors"] = prover_vectors(backend, settings, "prover")

    # Two in-domain proofs of a blob with distinct elements: y is the blob's
    # element at the root, and the proof verifies.
    blob, commitment = prover_blob(settings)
    n = settings.preset.field_elements_per_blob
    for m in (0, n - 1):
        z = Bytes32(settings.roots_of_unity[m].to_bytes(32, "big"))
        proof, y = Kzg.compute_kzg_proof(blob, z, settings, backend)
        if bytes(y) != bytes(blob)[32 * m : 32 * m + 32]:
            raise AssertionError(f"in-domain z = roots[{m}]: y is not the blob's element")
        if Kzg.verify_kzg_proof(commitment, z, y, proof, settings, backend) is not True:
            raise AssertionError(f"in-domain z = roots[{m}]: the proof does not verify")
        report.setdefault("in_domain", []).append(m)
    log(f"prover: in-domain proofs at roots[0] and roots[{n - 1}]: y is the blob's element and verify_kzg_proof accepts")

    # Launch counts of one commit and one proof: counts set to 0 just
    # before, read just after.  M1 and M2 once per MSM, and no K3: the MSM
    # reduces its own sums (neither call launches K3 outside the MSM).
    entry = prover_calls(backend, settings, blob, commitment)
    for name in ("commit", "proof"):
        _build.reset_launches()
        entry[name]()
        torch.cuda.synchronize()
        report["launches"][name] = dict(_build.LAUNCHES)
        msm = {e: report["launches"][name][e] for e in ("kzg_glv_digits", "kzg_msm_glv", "kzg_proj_add")}
        if msm != {"kzg_glv_digits": 1, "kzg_msm_glv": 1, "kzg_proj_add": 0}:
            raise AssertionError(f"{name}: M1, M2 and K3 launches {msm}, expected one, one and none")
        log(f"prover: launches in one {name}: {sum(report['launches'][name].values())}: {json.dumps({e: c for e, c in report['launches'][name].items() if c})}")

    # Host-clock milliseconds of each entry point (median of 3) and the
    # device milliseconds of the parts of a commit and a proof (CUDA events
    # around each part, median of 3; a part's time includes any wait for
    # the host to enqueue it).
    report["host_steps_ms"] = {}
    for name, fn in entry.items():
        times, stages, steps = [], {}, {}
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
            if name != "verify_blob":
                for s, v in backend.stage_ms().items():
                    stages.setdefault(s, []).append(v)
                for s, v in backend.host_ms.items():
                    steps.setdefault(s, []).append(v)
        report["host_ms"][name] = statistics.median(times)
        report.setdefault("runs_ms", {})[name] = times
        if stages:
            report["stage_ms"][name] = {s: statistics.median(v) for s, v in stages.items()}
            report["host_steps_ms"][name] = {s: statistics.median(v) for s, v in steps.items()}
        log(
            f"prover: {name}: {report['host_ms'][name]:.2f} ms end to end (host clock, median of 3); device ms of its parts "
            f"(CUDA events, median of 3): {json.dumps(report['stage_ms'].get(name, {}))}; host ms between the backend's steps: "
            f"{json.dumps(report['host_steps_ms'].get(name, {}))}"
        )
    report["verify_blob_steps_ms"] = verify_blob_steps(backend, settings, blob, commitment, bytes(entry["blob_proof"]()))
    log(f"prover: verify_blob_kzg_proof on the card, its steps alone (host clock, median of 3): {json.dumps(report['verify_blob_steps_ms'])}")
    # The host path the port replaces, once each on this machine's CPU: the
    # golden Pippenger and the host quotient loop.
    from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend

    golden = GoldenBackend()
    z_out = Bytes32((0x5EED).to_bytes(32, "big"))
    for name, fn in (
        ("commit", lambda: Kzg.blob_to_kzg_commitment(blob, settings, golden)),
        ("proof", lambda: Kzg.compute_kzg_proof(blob, z_out, settings, golden)),
    ):
        t = time.perf_counter()
        want = fn()
        report["host_ms"][f"golden_{name}"] = (time.perf_counter() - t) * 1e3
        if want != entry[name]():
            raise AssertionError(f"{name}: the card and the golden backend disagree")
    log(f"prover: the golden host path, once: commit {report['host_ms']['golden_commit']:.0f} ms, proof {report['host_ms']['golden_proof']:.0f} ms (host clock), the same bytes")
    return report


# ---------------------------------------------------------------------------
# Phase 3c: host placement
# ---------------------------------------------------------------------------


def host_placement(backend, settings) -> dict:
    """The verify path with ``KZG_TORCH_EVAL=host``, then the single-blob
    calls with ``KZG_TORCH_PROVER=host`` and ``KZG_TORCH_EVAL=host``, on the
    same backend: every vector and lane right, no kernel launched, each
    call's host-clock time (median of 3) beside the card's."""
    from kzg_rust_tpu_torch.ops import _build

    report = {}
    os.environ["KZG_TORCH_EVAL"] = "host"
    try:
        report["verify"] = main_path(backend, settings, host=True)
    finally:
        del os.environ["KZG_TORCH_EVAL"]

    blob, commitment = prover_blob(settings)
    card = {name: fn() for name, fn in prover_calls(backend, settings, blob, commitment).items()}
    os.environ.update(KZG_TORCH_EVAL="host", KZG_TORCH_PROVER="host")
    try:
        _build.reset_launches()
        report["vectors"] = prover_vectors(backend, settings, "host placement")
        report["host_ms"] = {}
        for name, fn in prover_calls(backend, settings, blob, commitment).items():
            if fn() != card[name]:
                raise AssertionError(f"host placement: {name} disagrees with the card")
            times = []
            for _ in range(3):
                t = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t) * 1e3)
            report["host_ms"][name] = statistics.median(times)
            report.setdefault("runs_ms", {})[name] = times
        if any(_build.LAUNCHES.values()):
            raise AssertionError(f"host placement launched kernels: {_build.LAUNCHES}")
    finally:
        del os.environ["KZG_TORCH_EVAL"], os.environ["KZG_TORCH_PROVER"]
    log(f"host placement: the prover calls give the card's bytes, with no launch; host clock, median of 3: {json.dumps(report['host_ms'])}")
    return report


# ---------------------------------------------------------------------------
# Phase 3d-3g: auto placement, the vectors by placement, a mesh, a world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def placed(**env):
    """The environment variables ``env`` set for the block, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


PLACEMENTS = ("device", "host", "auto", "host-piecewise")
# (label, (a1, a2, b1, b2), the engine's answer, the expected answer) of
# every pairing that phases 3 and 3e hand the engine on the card path.
RECORDED_PAIRINGS: list = []


@contextlib.contextmanager
def recording_pairings(backend, on: bool = True):
    """Within the block (where ``on``), ``backend.pairings_verify`` also
    appends (args, the engine's answer) to the list it yields."""
    seen = []
    if not on:
        yield seen
        return
    engine = backend.pairings_verify

    def recording(*args):
        ok = engine(*args)
        seen.append((args, ok))
        return ok

    backend.pairings_verify = recording
    try:
        yield seen
    finally:
        del backend.pairings_verify


def outcome(fn):
    """``fn()``'s value, or the class name of the KzgError it raised."""
    from kzg_rust_tpu_torch import KzgError

    try:
        return fn()
    except KzgError as e:
        return type(e).__name__


def faster_side(device_runs, host_runs):
    """``device`` or ``host`` where every run of one side beat every run of
    the other (faster by more than the runs' spread), else None."""
    if max(device_runs) < min(host_runs):
        return "device"
    if max(host_runs) < min(device_runs):
        return "host"
    return None


def fit_line(points) -> tuple[float, float]:
    """The least-squares (intercept, slope) through (x, y) points."""
    mx = statistics.mean(x for x, _ in points)
    my = statistics.mean(y for _, y in points)
    slope = sum((x - mx) * (y - my) for x, y in points) / sum((x - mx) ** 2 for x, _ in points)
    return my - slope * mx, slope


def sampled_lanes(n_sizes, host: bool = False) -> dict:
    """n -> the five lanes of main_path's batch at n (the same seeded picks)."""
    import numpy as np

    from kzg_rust_tpu_torch import Bytes48

    triples = valid_triples()
    nrng = np.random.default_rng(SEED)
    sub_point = Bytes48(out_of_subgroup_compressed(random.Random(SEED)))
    picks = {n: nrng.integers(0, len(triples), size=n) for n in BATCH_SIZES}
    return {n: batch_lanes(triples, picks[n], sub_point, host) for n in n_sizes}


def batch_outcomes(backend, settings, lanes) -> dict:
    """The 22 mainnet batch vectors and every lane of ``lanes`` through
    ``backend``: name -> its outcome (a bool or an error's class)."""
    from kzg_rust_tpu_torch import Blob, Bytes48, Kzg

    out = {}
    for f in sorted(glob.glob(os.path.join(ROOT, "tests", "vectors", "verify_blob_kzg_proof_batch", "*", "*", "data.yaml"))):
        inp, _ = read_vector(f)
        out[os.path.relpath(f, ROOT)] = outcome(
            lambda: Kzg.verify_blob_kzg_proof_batch(
                [Blob.from_hex(b) for b in inp["blobs"]], [Bytes48.from_hex(c) for c in inp["commitments"]], [Bytes48.from_hex(p) for p in inp["proofs"]], settings, backend
            )
        )
    for n, by_lane in lanes.items():
        for lane, (args, _) in by_lane.items():
            out[f"n={n}/{lane}"] = outcome(lambda: Kzg.verify_blob_kzg_proof_batch(*args, settings, backend))
    return out


def auto_placement(backend, settings, report, prover, host) -> dict:
    """``KZG_TORCH_EVAL=auto`` at each n and ``KZG_TORCH_PROVER=auto`` for a
    commit and a proof, on the backend of the other phases: each decision
    with its terms, its end-to-end time (host clock, median of 3), held
    against the same run's device and host times (phases 3, 3b, 3c): where
    one side beat the other in every run, auto must pick it.  The outcomes
    of the 22 batch vectors and the lanes under auto equal both explicit
    placements'.  Also the line through the device path's end-to-end times
    at each n, which the placement constants are fitted to."""
    from kzg_rust_tpu_torch import Bytes32, Kzg
    from kzg_rust_tpu_torch.backends import placement as P

    fixed_ms, per_blob_ms = fit_line([(n, report["e2e_ms"][n]) for n in BATCH_SIZES])
    out = {
        "fit": {"fixed_ms": fixed_ms, "per_blob_us": per_blob_ms * 1e3, "proof_ms": prover["host_ms"]["proof"]},
        "in_use": {"fixed_ms": P.AUTO_DEVICE_FIXED_S * 1e3, "per_blob_us": P.AUTO_DEVICE_PER_BLOB_S * 1e6, "proof_ms": P.AUTO_DEVICE_PROVE_S * 1e3},
        "verify": {},
        "prover": {},
    }
    log(f"auto: the device path's end to end fits {fixed_ms:.2f} ms + {per_blob_ms * 1e3:.2f} us a blob (least squares over n = {BATCH_SIZES}), a proof {prover['host_ms']['proof']:.2f} ms; in use: {json.dumps(out['in_use'])}")

    lanes = sampled_lanes(BATCH_SIZES)
    with placed(KZG_TORCH_EVAL="auto"):
        for n in BATCH_SIZES:
            backend.last_placement = {}
            runs = timed_batches(backend, settings, lanes[n]["valid"][0], host=True)
            decision = dict(backend.last_placement)
            if decision.get("op") != "verify_batch" or decision.get("n") != n:
                raise AssertionError(f"auto: n={n}: no decision recorded ({decision})")
            dev_runs, host_runs = report["e2e_runs_ms"][n], host["verify"]["e2e_runs_ms"][n]
            side = faster_side(dev_runs, host_runs)
            if side is not None and decision["choice"] != side:
                raise AssertionError(f"auto: n={n} picked {decision['choice']}, but this run measured the {side} faster in every run: device {dev_runs}, host {host_runs}")
            out["verify"][n] = {"decision": decision, "faster": side, "auto_ms": runs["e2e_ms"], "auto_runs_ms": runs["e2e_runs_ms"], "device_runs_ms": dev_runs, "host_runs_ms": host_runs}
            log(f"auto: n={n}: {json.dumps(decision)}; measured device {dev_runs} ms, host {host_runs} ms (faster beyond the spread: {side}); under auto {runs['e2e_ms']:.2f} ms (median of 3)")

    results = {}
    for mode in ("device", "host", "auto"):
        with placed(KZG_TORCH_EVAL=mode):
            results[mode] = batch_outcomes(backend, settings, lanes)
    differ = sorted(k for k in results["device"] if not results["device"][k] == results["host"][k] == results["auto"][k])
    if differ:
        raise AssertionError(f"auto: outcomes differ across placements: {[(k, results['device'][k], results['host'][k], results['auto'][k]) for k in differ]}")
    out["outcomes_equal"] = len(results["auto"])
    log(f"auto: {len(results['auto'])} batch outcomes (the 22 vectors and 5 lanes at each n) equal under device, host and auto")

    blob, _ = prover_blob(settings)
    z_out = Bytes32((0x5EED).to_bytes(32, "big"))
    calls = {"commit": lambda: bytes(Kzg.blob_to_kzg_commitment(blob, settings, backend)), "proof": lambda: [bytes(x) for x in Kzg.compute_kzg_proof(blob, z_out, settings, backend)]}
    for name, fn in calls.items():
        got = {}
        for mode in ("device", "host"):
            with placed(KZG_TORCH_PROVER=mode):
                got[mode] = fn()
        with placed(KZG_TORCH_PROVER="auto"):
            backend.last_placement = {}
            got["auto"] = fn()
            decision = dict(backend.last_placement)
            times = []
            for _ in range(3):
                t = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t) * 1e3)
        if not got["device"] == got["host"] == got["auto"]:
            raise AssertionError(f"auto: {name}: the placements disagree: {got}")
        if decision.get("op") != "prover":
            raise AssertionError(f"auto: {name}: no decision recorded ({decision})")
        dev_runs, host_runs = prover["runs_ms"][name], host["runs_ms"][name]
        side = faster_side(dev_runs, host_runs)
        if side is not None and decision["choice"] != side:
            raise AssertionError(f"auto: {name} picked {decision['choice']}, but this run measured the {side} faster in every run: device {dev_runs}, host {host_runs}")
        out["prover"][name] = {"decision": decision, "faster": side, "auto_ms": statistics.median(times), "auto_runs_ms": times, "device_runs_ms": dev_runs, "host_runs_ms": host_runs}
        log(f"auto: {name}: {json.dumps(decision)}; measured device {dev_runs} ms, host {host_runs} ms (faster beyond the spread: {side}); under auto {statistics.median(times):.2f} ms (median of 3); the same bytes under all three")
    return out


def run_vector(kind: str, inp: dict, settings, backend, bytes_per_blob: int):
    """One vector of ``kind`` through the public API: its output as the
    vectors write it (hex strings, a bool), None for a KzgError."""
    from kzg_rust_tpu_torch import Blob, Bytes32, Bytes48, Kzg, KzgError

    def hexed(x) -> str:
        return "0x" + bytes(x).hex()

    blob = lambda: Blob.from_hex(inp["blob"], bytes_per_blob=bytes_per_blob)  # noqa: E731
    calls = {
        "blob_to_kzg_commitment": lambda: hexed(Kzg.blob_to_kzg_commitment(blob(), settings, backend)),
        "compute_kzg_proof": lambda: [hexed(x) for x in Kzg.compute_kzg_proof(blob(), Bytes32.from_hex(inp["z"]), settings, backend)],
        "compute_blob_kzg_proof": lambda: hexed(Kzg.compute_blob_kzg_proof(blob(), Bytes48.from_hex(inp["commitment"]), settings, backend)),
        "verify_kzg_proof": lambda: Kzg.verify_kzg_proof(
            Bytes48.from_hex(inp["commitment"]), Bytes32.from_hex(inp["z"]), Bytes32.from_hex(inp["y"]), Bytes48.from_hex(inp["proof"]), settings, backend
        ),
        "verify_blob_kzg_proof": lambda: Kzg.verify_blob_kzg_proof(blob(), Bytes48.from_hex(inp["commitment"]), Bytes48.from_hex(inp["proof"]), settings, backend),
        "verify_blob_kzg_proof_batch": lambda: Kzg.verify_blob_kzg_proof_batch(
            [Blob.from_hex(b, bytes_per_blob=bytes_per_blob) for b in inp["blobs"]],
            [Bytes48.from_hex(c) for c in inp["commitments"]],
            [Bytes48.from_hex(p) for p in inp["proofs"]],
            settings,
            backend,
        ),
    }
    try:
        return calls[kind]()
    except KzgError:
        return None


def vectors_by_placement(backend, settings) -> dict:
    """The 92 mainnet ``verify_kzg_proof`` vectors on ``settings``, and every
    ``tests/vectors_minimal`` vector on the minimal setup (the minimal
    preset's 4-element shapes on the card), through ``backend`` under
    ``device``, ``host``, ``auto`` and ``host-piecewise`` (both variables):
    every outcome the vector's, the same under all four.  Under ``device``
    the pairing inputs that the mainnet vectors hand the engine are kept in
    RECORDED_PAIRINGS with the engine's answer and the vector's output."""
    from kzg_rust_tpu_torch import MINIMAL, Kzg

    minimal = Kzg.load_trusted_setup_file(os.path.join(ROOT, "data", "trusted_setup_minimal.txt"), MINIMAL)
    sets = {
        "mainnet verify_kzg_proof": (settings, sorted(glob.glob(os.path.join(ROOT, "tests", "vectors", "verify_kzg_proof", "*", "*", "data.yaml"))), 92),
        "minimal": (minimal, sorted(glob.glob(os.path.join(ROOT, "tests", "vectors_minimal", "*", "*", "*", "data.yaml"))), 28),
    }
    report = {}
    for label, (s, files, count) in sets.items():
        if len(files) != count:
            raise AssertionError(f"expected {count} {label} vectors, found {len(files)}")
        for mode in PLACEMENTS:
            record = mode == "device" and label.startswith("mainnet")
            with placed(KZG_TORCH_EVAL=mode, KZG_TORCH_PROVER=mode), recording_pairings(backend, record) as seen:
                t = time.perf_counter()
                for f in files:
                    inp, expected = read_vector(f)
                    kind = os.path.relpath(f, ROOT).split(os.sep)[-4]
                    got = run_vector(kind, inp, s, backend, s.preset.bytes_per_blob)
                    if got != expected:
                        raise AssertionError(f"{label} under {mode}: {f}: got {got}, expected {expected}")
                    RECORDED_PAIRINGS.extend((os.path.basename(os.path.dirname(f)), args, ok, expected) for args, ok in seen)
                    seen.clear()
                report[f"{label}/{mode}_s"] = time.perf_counter() - t
        report[label] = count
        seconds = ", ".join(f"{m} {report[f'{label}/{m}_s']:.2f} s" for m in PLACEMENTS)
        log(f"vectors: all {count} {label} vectors pass under {', '.join(PLACEMENTS)} ({seconds})")
    return report


PAIRING_KS = (1, 64, 1024)  # checks a P2 / P3 launch is timed at
PAIRING_P1_N = 4096  # Fp12 elements of each P1 launch
PAIRING_PLAIN_K = 64  # checks the plain P2 and P3 run at (K = 1 is its first lane)
# The pairings phases 3 and 3e hand the engine: the valid and swapped n = 64
# batches and the 72 mainnet proof vectors that decode; fewer means the
# recording lost some.
MIN_RECORDED_PAIRINGS = 74


def inv_chain(p: int) -> tuple[int, int]:
    """(products, squarings) of the Fermat chain p - 2 in csrc/tower.cuh
    (field.cuh pow_const: the table, four squarings a further 4-bit digit
    and a product a nonzero one)."""
    digits = [int(c, 16) for c in f"{p - 2:x}"]
    return max(digits) - 1 + sum(1 for d in digits[1:] if d), 4 * (len(digits) - 1)


def program_products(built: dict, kernel: str, names) -> int:
    """Fp products of the programs ``names`` of ``kernel`` run in order
    (ops/pairing_programs.py), the Fermat chains apart."""
    from kzg_rust_tpu_torch.ops import pairing_programs as PP

    return sum(built[kernel]["programs"][name].count(PP.LEVEL_MUL) for name in names)


def pairing_phase(device, sm_clock_hz: float, sms: int) -> tuple[list[dict], dict]:
    """Phase 3h, the device pairing: P1 (``kzg_fp12_op``) word for word
    against its plain version for each op code at [4096] (the Granger-Scott
    squaring on cyclotomic elements), P2 (``kzg_miller_loop``) at [2, 1]
    and [2, 64] and P3 (``kzg_final_exp``) with the real |x| at K = 1 and
    64 and with the tiny bits (1, 0), each value against its plain version;
    P2 and P3 timed at K = 1, 64 and 1024 (CUDA events, median of 3), and
    swept there over the lanes a group G (8, 16, 32), each variant's value
    equal to the default launch's; every pairing that phases 3 and 3e
    handed the engine through ``pairings_verify_device``, one at a time and as one batched call, plus
    lanes with an infinity argument, each answer the engine's and the
    expected one; one check at K = 1 on the host clock beside the engine's.
    Returns the rows (the P rows of the kernels line) and the report."""
    import numpy as np
    import torch

    from kzg_rust_tpu_torch import hostcrypto
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.golden import pairing as gp
    from kzg_rust_tpu_torch.golden.field import P as FP_P
    from kzg_rust_tpu_torch.ops import limbs as L
    from kzg_rust_tpu_torch.ops import pairing as PR
    from kzg_rust_tpu_torch.ops import pairing_programs as PP
    from kzg_rust_tpu_torch.ops import tower as T

    t_phase = time.perf_counter()
    built = PP.build()
    imad_s = sms * IMAD_PER_CLOCK_PER_SM * sm_clock_hz
    mul_ops, sqr_ops = 2 * (2 * 144 + 12), 2 * (78 + 144 + 12)  # IMADs of an Fp product and squaring
    chain_p, chain_s = inv_chain(FP_P)
    src = "kzg_rust_tpu_torch/csrc/pairing_kernels.cu"
    jp = "kzg_rust_tpu/ops/pairing.py"
    rows, report = [], {"ptxas": {}, "ms": {}, "sweep": {}, "checks": {}}

    def row(name, got, want, timed, plain_s, lanes_ops, nbytes, replaces, keep, shape, reps=3, op=None):
        g64, w64 = got.to(torch.int64) & 0xFFFFFFFF, want.to(torch.int64) & 0xFFFFFFFF
        err = int((g64 - w64).abs().max().item()) if got.numel() else 0
        label = f"{name} {op}" if op else name
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{label} at {shape}: the kernel disagrees with its plain version (max |diff| {err})")
        ms, call_ms = graph_ms(timed, reps), cuda_ms(timed, 3)
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, lanes_ops / imad_s * 1e3
        r = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None, "shape": shape, "call_ms": call_ms, "l2": "as replayed",
        }
        if op:
            r["op"] = op
        log(f"kernel {label}: equal to plain at {shape}; {ms:.4f} ms on the card (CUDA graph replay; {call_ms:.4f} ms per call), plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
        r["kept"] = keep
        rows.append(r)
        return r

    def plain_timed(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for label, (src_, regs, spills) in ptxas_report().items():
        if src_ == "pairing_kernels.cu":
            report["ptxas"][label] = f"{regs}; {spills}"
            log(f"pairing: ptxas {label}: {regs}; {spills}")
    report["build_s"] = _build_seconds("pairing_kernels.cu")

    # P1 at [4096]: seeded elements; cyclotomic ones for the Granger-Scott
    # squaring, made on the card by P1's own product, inversion and
    # Frobenius (each held to its plain version here first).
    rng = np.random.default_rng(SEED)
    n = PAIRING_P1_N

    def rand_elts(shape):
        vals = random_field(rng, FP_P, int(np.prod(shape)))
        return torch.from_numpy(L.ints_to_words(12, vals).reshape(tuple(shape) + (12,))).to(device)

    a, b, line = rand_elts((n, 2, 3, 2)), rand_elts((n, 2, 3, 2)), rand_elts((n, 3, 2))
    a[0] = 0  # inv(0) = 0
    for op in ("mul", "sqr", "frobenius", "inv", "mul_by_line", "cyclo_sqr"):
        x = a
        if op == "cyclo_sqr":
            m = T.fp12_op("mul", T.DEVICE.f12_conj(a[1:]), T.fp12_op("inv", a[1:]))
            x = T.fp12_op("mul", T.fp12_op("frobenius", T.fp12_op("frobenius", m)), m)
            if not bool(T.fp12_is_one(T.fp12_op("mul", x, T.DEVICE.f12_conj(x))).all()):
                raise AssertionError("P1: the easy part's image does not have norm one")
        y = {"mul": b, "mul_by_line": line}.get(op)
        got = T.fp12_op(op, x, y)
        want, plain_s = plain_timed(T.fp12_op_plain, op, x, y)
        k = x.shape[0]
        ops = k * (program_products(built, "p1", [op]) * mul_ops + ((chain_p * mul_ops + chain_s * sqr_ops) if op == "inv" else 0))
        words = 144 + {"mul": 144, "mul_by_line": 72}.get(op, 0) + 144
        row("P1 kzg_fp12_op", got, want, lambda: T.fp12_op(op, x, y), plain_s, ops, k * words * 4, "none (one Fp12 function of ops/tower.py a launch)", op == "mul", [k, 144], reps=10, op=op)

    # P2 and P3 on the pairings the card path handed the engine.
    if len(RECORDED_PAIRINGS) < MIN_RECORDED_PAIRINGS:
        raise AssertionError(f"only {len(RECORDED_PAIRINGS)} recorded pairing inputs, expected {MIN_RECORDED_PAIRINGS}")
    checks = [args for _, args, _, _ in RECORDED_PAIRINGS]
    xp, yp, qx, qy, active = PR.pairing_inputs([checks[i % len(checks)] for i in range(max(PAIRING_KS))], device)
    q = PR._q_packed(qx, qy)
    # The plain versions run once, at K = PAIRING_PLAIN_K (a few seconds a
    # call on the card, launch-bound); the kernels' K = 1 values are held
    # against its first lane, and each K is timed.
    args_of = {k: (xp[:, :k].contiguous(), yp[:, :k].contiguous(), q[:, :k].contiguous(), active[:, :k].contiguous()) for k in PAIRING_KS}
    f_of = {k: PR.miller_loop(*args_of[k]) for k in PAIRING_KS}
    kp = PAIRING_PLAIN_K
    p2_ops = {k: int(active[:, :k].sum()) * program_products(built, "p2", PP.p2_sequence()) * mul_ops for k in PAIRING_KS}
    p3_products = program_products(built, "p3", PP.p3_sequence(PR._ABS_X_BITS))
    p3_ops = {k: k * (p3_products * mul_ops + chain_p * mul_ops + chain_s * sqr_ops) for k in PAIRING_KS}
    want2, plain_s = plain_timed(PR.miller_loop_plain, *args_of[kp])
    row("P2 kzg_miller_loop", f_of[kp], want2, lambda: PR.miller_loop(*args_of[kp]), plain_s, p2_ops[kp], 2 * kp * (72 * 4 + 1 + 144 * 4), f"{jp}:202 miller_loop_kernel (XLA)", True, [2, kp])
    want3, plain_s = plain_timed(PR.final_exp_plain, f_of[kp], PR._ABS_X_BITS, True)
    row(
        "P3 kzg_final_exp", PR.final_exp(f_of[kp], value=True), want3, lambda: PR.final_exp(f_of[kp]), plain_s, p3_ops[kp], kp * 3 * 144 * 4,
        f"{jp}:264 _easy_part_kernel, :236 _exp_by_x_with_bits, :275 _mul_conj_kernel, :280 _mul_frob_kernel, :294 _hard_tail_kernel (XLA)", True, [kp],
    )
    if not torch.equal(PR.final_exp(f_of[kp]).cpu(), T.fp12_is_one(want3).cpu()):
        raise AssertionError(f"P3 at K = {kp}: the flags are not the value's is-one test")
    if not (torch.equal(f_of[1], want2[:, :1]) and torch.equal(PR.final_exp(f_of[1], value=True), want3[:1])):
        raise AssertionError("P2 or P3 at K = 1 disagrees with the first lane of its plain version")
    want = PR.final_exp_plain(f_of[1], (1, 0), True)
    if not torch.equal(PR.final_exp(f_of[1], (1, 0), value=True), want):
        raise AssertionError("P3 with the bits (1, 0) disagrees with its plain version")
    log(f"kernel P2, P3: at K = 1 equal to the first lane of the plain versions at K = {kp}; P3 with the bits (1, 0) equal to plain at K = 1")
    for k in PAIRING_KS:
        report["ms"][f"P2 K={k}"] = graph_ms(lambda: PR.miller_loop(*args_of[k]), 3)
        report["ms"][f"P3 K={k}"] = graph_ms(lambda: PR.final_exp(f_of[k]), 3)
        report["ms"][f"P2 K={k} bound"] = p2_ops[k] / imad_s * 1e3
        report["ms"][f"P3 K={k} bound"] = p3_ops[k] / imad_s * 1e3
        report["ms"][f"P2 K={k} G"] = T.pairing_group(2 * k)
        report["ms"][f"P3 K={k} G"] = T.pairing_group(k)
        # The sweep: every G for P2 and P3, each variant's words the
        # default launch's.
        value = PR.final_exp(f_of[k], value=True)
        for g in T.GROUP_LANES:
            if not torch.equal(PR.miller_loop(*args_of[k], group=g), f_of[k]):
                raise AssertionError(f"P2 at K = {k}, G = {g}: the value differs from the default launch's")
            report["sweep"][f"P2 K={k} G={g}"] = graph_ms(lambda: PR.miller_loop(*args_of[k], group=g), 3)
            if not torch.equal(PR.final_exp(f_of[k], value=True, group=g), value):
                raise AssertionError(f"P3 at K = {k}, G = {g}: the value differs from the default launch's")
            report["sweep"][f"P3 K={k} G={g}"] = graph_ms(lambda: PR.final_exp(f_of[k], group=g), 3)
        log(f"pairing: sweep at K = {k} (ms, CUDA graph replays): {json.dumps({key: round(v, 4) for key, v in report['sweep'].items() if f' K={k} ' in key})}")

    # Every recorded pairing through the device entry point: one at a time,
    # then all in one batched call, with infinity lanes added.
    g1, g2 = gc.G1_GENERATOR, gc.G2_GENERATOR
    inf = [
        ("both pairs at infinity", (None, g2, None, g2)),
        ("P0 at infinity", (None, g2) + checks[0][2:]),
        ("Q0 at infinity", (checks[0][0], None) + checks[0][2:]),
        ("P1 and Q1 at infinity", (g1, g2, None, None)),
        ("e(G1, G2) == e(G1, G2) with Q1 at infinity", (g1, g2, g1, None)),
    ]
    labels = [lab for lab, _, _, _ in RECORDED_PAIRINGS] + [lab for lab, _ in inf]
    all_checks = checks + [c for _, c in inf]
    engine = [hostcrypto.pairings_verify(*c) for c in all_checks]
    expected = [exp for _, _, _, exp in RECORDED_PAIRINGS] + [gp.pairings_verify(*c) for _, c in inf]
    recorded_engine = [ok for _, _, ok, _ in RECORDED_PAIRINGS]
    if engine[: len(checks)] != recorded_engine or engine != expected:
        raise AssertionError("the engine's pairings disagree with the recorded or expected answers")
    t = time.perf_counter()
    one_by_one = [PR.pairings_verify_device(*c) for c in all_checks]
    one_s = time.perf_counter() - t
    t = time.perf_counter()
    batched = PR.pairings_verify_device_batch(all_checks)
    batch_s = time.perf_counter() - t
    for lab, want_, one, bat in zip(labels, expected, one_by_one, batched):
        if not (one is bat is want_):
            raise AssertionError(f"device pairing {lab}: one at a time {one}, batched {bat}, engine and expected {want_}")
    report["checks"] = {"count": len(all_checks), "true": sum(expected), "one_at_a_time_s": one_s, "batched_s": batch_s}
    log(f"pairing: {len(all_checks)} checks ({len(checks)} recorded from phases 3 and 3e, {len(inf)} with infinity) through pairings_verify_device: every answer the engine's and the expected one, one at a time ({one_s:.2f} s) and in one batched call ({batch_s * 1e3:.1f} ms host clock)")

    # One check at K = 1 on the host clock, beside the engine's pairing.
    valid = checks[0]
    dev_ms, eng_ms = [], []
    for _ in range(3):
        t = time.perf_counter()
        PR.pairings_verify_device(*valid)
        dev_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        hostcrypto.pairings_verify(*valid)
        eng_ms.append((time.perf_counter() - t) * 1e3)
    report["check_k1_host_ms"] = {"device": statistics.median(dev_ms), "engine": statistics.median(eng_ms)}
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"pairing: one check at K = 1, host clock, median of 3: the card {report['check_k1_host_ms']['device']:.2f} ms, the engine {report['check_k1_host_ms']['engine']:.2f} ms; P2 / P3 ms at K = {PAIRING_KS}: {json.dumps(report['ms'])}; phase {report['phase_s']:.1f} s")
    return rows, report


def _build_seconds(src: str) -> float:
    from kzg_rust_tpu_torch.ops import _build

    return _build.BUILD_INFO.get(src, {}).get("seconds", 0.0)


def stage_inputs(device, lanes):
    """Stage inputs of the valid batch of ``lanes``: its [2n, 48] compressed
    points, seeded RLC digits and the generator's digits on ``device``, and
    its blob bytes [n, 4096, 32] and seeded evaluation points there."""
    import numpy as np
    import torch

    from kzg_rust_tpu_torch.golden.field import R
    from kzg_rust_tpu_torch.ops import limbs as L
    from kzg_rust_tpu_torch.ops import msm as M
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    blobs, cs, ps = lanes["valid"][0]
    n = len(blobs)
    rows = [bytes(x) for pair in zip(cs, ps) for x in pair]
    prng = random.Random(SEED + n)
    rp, rz = [prng.randrange(R) for _ in range(n)], [prng.randrange(R) for _ in range(n)]
    up = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    return {
        "comp": up(np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(2 * n, 48)),
        "digits": up(V.stage2_digits(n, rp, rz)),
        "sy": up(M.recode_signed_digits([prng.randrange(R)], 1)),
        "blobs": up(np.frombuffer(b"".join(bytes(b) for b in blobs), dtype=np.uint8).reshape(n, -1, 32)),
        "xs": up(L.ints_to_words(L.FR.nwords, [prng.randrange(R) for _ in range(n)])),
    }


def cuda_synced_ms(fn, reps: int = 3) -> tuple:
    """``fn()``'s result and its host-clock milliseconds, synchronised
    (median of ``reps``, the first call untimed)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return out, statistics.median(times)


def sharded_phase(backend, settings, report, prover) -> dict:
    """The sharded paths on a mesh of two shards on the one card, [cuda:0,
    cuda:0], put in place by replacing a second backend's mesh method: the
    batch at n = 64 and 512 (every lane's outcome), its three stages at
    n = 64 held against the unsharded ones (flags, affine points, ys), a
    commit and a proof on the point mesh, the MSM, and ``barycentric_eval``
    on the domain mesh at mainnet width, each equal to the unsharded path's
    and timed (host clock, synchronised, median of 3).  Two shards on one
    card share its SMs: no gain is possible, and none is claimed."""
    import torch

    from kzg_rust_tpu_torch import Bytes32, Kzg, protocol
    from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend
    from kzg_rust_tpu_torch.golden.field import R
    from kzg_rust_tpu_torch.ops import curve as C
    from kzg_rust_tpu_torch.ops import verify_kernels as V
    from kzg_rust_tpu_torch.parallel import sharded as S

    dev = backend.device
    mesh = [dev, dev]
    sharded = TorchBackend(device=dev)
    sharded._auto_mesh = lambda n, kind: mesh if n % 2 == 0 else None
    out = {"mesh": [str(d) for d in mesh], "batch_ms": {}, "stages_ms": {}, "prover_ms": {}}
    lanes = sampled_lanes(SHARDED_SIZES)
    for n, by_lane in lanes.items():
        for lane, (args, _) in by_lane.items():
            got = outcome(lambda: Kzg.verify_blob_kzg_proof_batch(*args, settings, sharded))
            want = outcome(lambda: Kzg.verify_blob_kzg_proof_batch(*args, settings, backend))
            if got != want:
                raise AssertionError(f"sharded: n={n} lane {lane}: {got!r} on the mesh, {want!r} unsharded")
        runs = timed_batches(sharded, settings, by_lane["valid"][0], host=True)
        out["batch_ms"][n] = {"sharded": runs["e2e_ms"], "sharded_runs": runs["e2e_runs_ms"], "unsharded": report["e2e_ms"][n]}
        log(f"sharded: n={n}: the five lanes' outcomes equal the unsharded path's; a valid batch {runs['e2e_ms']:.2f} ms on the mesh, {report['e2e_ms'][n]:.2f} unsharded (host clock, median of 3)")

    inp = stage_inputs(dev, lanes[SHARDED_SIZES[0]])
    gen = backend._gen_table()
    ctx = backend._fr_ctx(settings)
    (b1, b2, flags), one_ms = cuda_synced_ms(lambda: V.batch_points(inp["comp"]))
    (sb1, sb2, sflags), two_ms = cuda_synced_ms(lambda: S.sharded_batch_points(inp["comp"], mesh))
    if flags.tolist() != sflags.tolist() or flags.tolist() != [1, 1]:
        raise AssertionError(f"sharded stage 1: flags {sflags.tolist()} on the mesh, {flags.tolist()} unsharded")
    out["stages_ms"]["stage1"] = {"sharded": two_ms, "unsharded": one_ms}
    o, one_ms = cuda_synced_ms(lambda: V.batch_stage2(b1, b2, inp["digits"], gen, inp["sy"]))
    so, two_ms = cuda_synced_ms(lambda: S.sharded_batch_stage2(sb1, sb2, inp["digits"], gen, inp["sy"], mesh))
    if C.proj_to_points(o.cpu()) != C.proj_to_points(so.cpu()):
        raise AssertionError("sharded stage 2: the affine points differ from the unsharded ones")
    out["stages_ms"]["stage2"] = {"sharded": two_ms, "unsharded": one_ms}
    (ys, ok), one_ms = cuda_synced_ms(lambda: V.bary_batch_from_bytes(ctx, inp["blobs"], inp["xs"]))
    (sys_, sok), two_ms = cuda_synced_ms(lambda: S.sharded_bary_blobs([ctx, ctx], inp["blobs"], inp["xs"], mesh))
    if not torch.equal(ys, sys_) or not bool(ok) or not bool(sok):
        raise AssertionError("sharded barycentric: the ys or the flag differ from the unsharded ones")
    out["stages_ms"]["bary"] = {"sharded": two_ms, "unsharded": one_ms}
    log(f"sharded: n={SHARDED_SIZES[0]} stages on the mesh equal the unsharded ones (flags, affine points, ys word for word); ms (synchronised, median of 3): {json.dumps(out['stages_ms'])}")

    blob, commitment = prover_blob(settings)
    t = time.perf_counter()
    ctx2 = sharded._msm_ctx(settings)
    torch.cuda.synchronize()
    out["table_build_ms"] = (time.perf_counter() - t) * 1e3
    if not isinstance(ctx2, S.ShardedMsmContext) or len(ctx2.shards) != 2:
        raise AssertionError(f"sharded: the point mesh's context is {type(ctx2).__name__}")
    z_out = Bytes32((0x5EED).to_bytes(32, "big"))
    evals = protocol.blob_to_polynomial(settings, blob)
    prng = random.Random(SEED)
    scalars = [prng.randrange(R) for _ in range(settings.preset.field_elements_per_blob)]
    x = prng.randrange(R)
    checks = {
        "commit": lambda be: bytes(Kzg.blob_to_kzg_commitment(blob, settings, be)),
        "proof": lambda be: [bytes(v) for v in Kzg.compute_kzg_proof(blob, z_out, settings, be)],
        "msm": lambda be: be.msm_g1_lagrange(settings, scalars),
        "barycentric_eval": lambda be: be.barycentric_eval(settings, evals, x),
    }
    for name, fn in checks.items():
        got, two_ms = cuda_synced_ms(lambda: fn(sharded))
        want, one_ms = cuda_synced_ms(lambda: fn(backend))
        if got != want:
            raise AssertionError(f"sharded {name}: {got!r} on the mesh, {want!r} unsharded")
        out["prover_ms"][name] = {"sharded": two_ms, "unsharded": one_ms}
    if out["prover_ms"] and checks["commit"](sharded) != bytes(commitment):
        raise AssertionError("sharded commit: not the vector's commitment")
    log(f"sharded: the point-mesh commit, proof and MSM and the domain-mesh evaluation equal the unsharded path's; the split table built in {out['table_build_ms']:.1f} ms; ms (synchronised, median of 3): {json.dumps(out['prover_ms'])}")
    return out


def distributed_phase(backend, settings) -> dict:
    """``parallel/distributed.py`` as a world of one rank over NCCL, with
    local devices [cuda:0, cuda:0]: the 2-axis stages at n = 64 and the
    2-axis MSM at mainnet width, equal to the unsharded path's (flags,
    affine points)."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    from kzg_rust_tpu_torch.golden.field import R
    from kzg_rust_tpu_torch.ops import curve as C
    from kzg_rust_tpu_torch.ops import verify_kernels as V
    from kzg_rust_tpu_torch.parallel import distributed as D

    dev = backend.device
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = {}
    t = time.perf_counter()
    D.initialize_distributed(f"tcp://localhost:{port}", world_size=1, rank=0, backend="nccl", timeout=datetime.timedelta(seconds=120))
    out["init_ms"] = (time.perf_counter() - t) * 1e3
    try:
        mesh = D.host_chip_mesh([dev, dev])
        n = SHARDED_SIZES[0]
        inp = stage_inputs(dev, sampled_lanes((n,))[n])
        gen = backend._gen_table()
        b1, b2, flags = V.batch_points(inp["comp"])
        (db1, db2, dflags), out["stage1_ms"] = cuda_synced_ms(lambda: D.batch_points_2axis(inp["comp"], mesh))
        if dflags.tolist() != flags.tolist():
            raise AssertionError(f"distributed stage 1: flags {dflags.tolist()}, unsharded {flags.tolist()}")
        o = V.batch_stage2(b1, b2, inp["digits"], gen, inp["sy"])
        do, out["stage2_ms"] = cuda_synced_ms(lambda: D.batch_stage2_2axis(db1, db2, inp["digits"], gen, inp["sy"], mesh))
        if C.proj_to_points(do.cpu()) != C.proj_to_points(o.cpu()):
            raise AssertionError("distributed stage 2: the affine points differ from the unsharded ones")
        t = time.perf_counter()
        ctx = D.ShardedMsmContext2Axis.build(settings, mesh)
        torch.cuda.synchronize()
        out["table_build_ms"] = (time.perf_counter() - t) * 1e3
        prng = random.Random(SEED + 1)
        scalars = [prng.randrange(R) for _ in range(settings.preset.field_elements_per_blob)]
        got, out["msm_ms"] = cuda_synced_ms(lambda: D.msm_fixed_base_2axis(ctx, scalars))
        if got != backend.msm_g1_lagrange(settings, scalars):
            raise AssertionError("distributed MSM: the point differs from the unsharded MSM's")
    finally:
        dist.destroy_process_group()
    log(f"distributed: a world of one rank over NCCL on [{dev}, {dev}]: the 2-axis stages (n = {n}) and MSM ({len(scalars)} points) equal the unsharded path's; ms: {json.dumps(out)}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "kzg_rust_tpu_torch", "csrc")):
        print("chip_smoke: the kzg_rust_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    if sys.argv[1:] not in ([], ["--replay-kernels"], ["--batches"]):
        print("usage: python3 chip_smoke.py [--replay-kernels | --batches]", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Everything the run writes stays inside the checkout.
    os.environ.setdefault("KZG_TORCH_CACHE_DIR", os.path.join(ROOT, "build", "setup_cache"))

    from kzg_rust_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if sys.argv[1:]:
        # The barycentric graph's device operations alone (replay_kernels),
        # or the valid batches alone (batches_alone), for the package beside
        # this script: a copy of this script beside an older checkout's
        # package measures that package.
        _build.build()
        card = nvidia_smi("name,power.limit")
        log(card)
        if sys.argv[1] == "--replay-kernels":
            log(json.dumps({"replay_kernels": replay_kernels(), "card": card}))
        else:
            log(json.dumps({"batches": batches_alone(), "card": card}))
        return 0

    # Phase 1: build.
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.BUILD_INFO)} sources in parallel")
    for label, (src, regs, spills) in ptxas_report().items():
        log(f"build: {src} {label}: {regs}; {spills}")
    sass = sass_counts()
    if sass is None:
        log("sass: no cuobjdump in the CUDA toolkit; instructions per product and squaring not counted")
    else:
        per_call = {
            f"{f}_mont_{op}": sass[f"probe_{f}_mont_{op}"] - sass[f"probe_{f}_load_store"]
            for f in ("fp", "fr")
            for op in ("mul", "sqr")
        } | {f"fp_lane_mul_{n}": sass[f"probe_fp_lane_mul_{n}"] - sass["probe_fp_load_store"] for n in (2, 4)}
        log(
            f"sass: instructions per call on sm_90a, less the load/store probe of the field: {json.dumps(per_call)} "
            f"(probe kernels {json.dumps(sass)})"
        )
    card = nvidia_smi("name,power.limit")
    log(card)

    # Phase 1b: the native host engine, built for this machine's CPU.
    from kzg_rust_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.require()
    log(
        f"engine: {native.BUILD_INFO['path']} loaded in {time.perf_counter() - t0:.1f} s "
        f"(build {native.BUILD_INFO['seconds']:.1f} s), ABI {lib.kzg_native_abi_version()}, {os.cpu_count()} CPUs"
    )
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f"bounds: {sms} SMs at the max SM clock {clock_mhz:.0f} MHz, {IMAD_PER_CLOCK_PER_SM} IMAD/clock/SM, {HBM_BYTES_PER_S / 1e12} TB/s")

    # Phase 2: kernels against their plain versions.
    rows, every = check_kernels(device, clock_mhz * 1e6, sms)

    # Phase 2b: the engine against golden; phase 3: the verify path, then
    # (3b) the prover path, then (3c) both under host placement, on one backend.
    from kzg_rust_tpu_torch import Kzg
    from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend

    t0 = time.perf_counter()
    settings = Kzg.load_trusted_setup_file(os.path.join(ROOT, "data", "trusted_setup.txt"))
    log(f"main: mainnet trusted setup loaded in {time.perf_counter() - t0:.2f} s")
    backend = TorchBackend(time_stages=True)
    engine = check_engine(backend, settings)
    report = main_path(backend, settings)
    prover = prover_path(backend, settings)
    host = host_placement(backend, settings)
    # Phase 3e: the single-call and minimal vectors under every placement;
    # 3f: two shards on the card; 3g: a world of one; 3d: auto placement.
    vectors = vectors_by_placement(backend, settings)
    # Phase 3h: the device pairing on the pairings of phases 3 and 3e.
    p_rows, pairing = pairing_phase(device, clock_mhz * 1e6, sms)
    rows += [r for r in p_rows if r.pop("kept")]
    every += p_rows
    sharded = sharded_phase(backend, settings, report, prover)
    world = distributed_phase(backend, settings)
    auto = auto_placement(backend, settings, report, prover, host)

    # Phase 4: report.  A kernel's launches on the path: one valid n = 64
    # batch, one commit and one proof, each counted from 0.  In a larger
    # batch a kernel's launches are its direct ones plus the barycentric
    # graph's replays times its launches in one replay.
    small = BATCH_SIZES[0]
    graphs = report["graph_kernels"]

    def per_kernel(counts):
        return {e: counts[e] + sum(counts.get(g, 0) * k.get(e, 0) for g, k in graphs.items()) for e in _build.ENTRY_POINTS}

    runs = {f"n{small}": report["launches"][small], "commit": prover["launches"]["commit"], "proof": prover["launches"]["proof"]}
    for row in every:
        entry = row["name"].split()[-1]
        row["launches"] = sum(counts[entry] for counts in runs.values())
        row["launches_by_run"] = {name: counts[entry] for name, counts in runs.items()}
        for n in BATCH_SIZES[1:]:
            row[f"launches_n{n}"] = per_kernel(report["launches"][n])[entry]
    expected = {f"n{n}": batch_launches(npad_of(n))["total"] for n in BATCH_SIZES} | PATH_LAUNCHES
    totals = {name: sum(counts.values()) for name, counts in runs.items()} | {f"n{n}": sum(report["launches"][n].values()) for n in BATCH_SIZES}
    if totals != expected:
        raise AssertionError(f"launches per run {totals}, expected {expected}")
    missing = [e for e in _build.ENTRY_POINTS if e not in OFF_PATH and not any(counts[e] for counts in runs.values())]
    if missing:
        raise AssertionError(f"kernels of the path never launched by the n={small} batch, a commit or a proof: {missing}")
    # Stage 1 is kernel A, the window-base chain and kernel B, one launch
    # each a chunk and nothing else (no Fp compare, K1, K3 or Fp chain); the
    # batch has no one-step K4 and no Fp chain (the square root is inside
    # A); the Fermat inversion and x^4096 are two Fr chains a barycentric
    # evaluation, launched directly at full width and one replay a chunk in
    # the chunked regime, where no barycentric kernel launches directly.
    for name, kernels in graphs.items():
        if sum(kernels.values()) != BARY_LAUNCHES or kernels.get("kzg_fr_sum_rows") != 1 or kernels.get("kzg_fr_ingest") != 1 or kernels.get("kzg_fr_sub") != 2:
            raise AssertionError(f"graph {name}: a replay runs {json.dumps(kernels)}, expected {BARY_LAUNCHES} kernels, one domain sum, one ingest, two Fr subs")
    # The blobs are ingested and checked by kzg_fr_ingest, once a barycentric
    # evaluation (at full width or a replay), a commit and a proof; the
    # generic Fr compare runs in none of them.
    ingests = {name: counts["kzg_fr_ingest"] for name, counts in runs.items()}
    if ingests != {f"n{small}": 1, "commit": 1, "proof": 1} or any(
        per_kernel(counts)["kzg_fr_cmp"] for counts in list(runs.values()) + list(report["launches"].values())
    ):
        raise AssertionError(f"ingest launches {ingests}, expected one each; or kzg_fr_cmp launched on the path")
    for n in BATCH_SIZES:
        parts = batch_launches(npad_of(n))
        counts = report["launches"][n]
        chunks = parts["stage1"] // 3
        if report["stage1_launches"][n] != {e: c * chunks for e, c in STAGE1_LAUNCHES.items()}:
            raise AssertionError(f"n={n}: stage 1 launched {report['stage1_launches'][n]}, expected {chunks} x {STAGE1_LAUNCHES}")
        replays = parts["graph:bary_chunk"]
        got = {e: counts[e] for e in ("kzg_proj_double_chain", "kzg_proj_double", "kzg_fp_pow_const", "kzg_fr_pow_const")}
        got["graph:bary_chunk"] = counts.get("graph:bary_chunk", 0)
        want = {"kzg_proj_double_chain": chunks, "kzg_proj_double": 0, "kzg_fp_pow_const": 0, "kzg_fr_pow_const": 0 if replays else 2, "graph:bary_chunk": replays}
        if got != want:
            raise AssertionError(f"n={n}: chain launches and replays {got}, expected {want}")
        log(
            f"launches: n={n}: {totals[f'n{n}']} in one valid batch ({json.dumps(parts)}; a replay counts one); "
            f"{sum(per_kernel(counts).values())} kernels in all; stage 1 {json.dumps(report['stage1_launches'][n])}; chains and replays {json.dumps(got)}"
        )
    for row in rows:
        per_n = ", ".join(f"{row[f'launches_n{n}']} in one n={n} batch" for n in BATCH_SIZES[1:])
        log(f"launches: {row['name']}: {row['launches']} on the path ({json.dumps(row['launches_by_run'])}), {per_n}")
    log(
        json.dumps(
            {
                k: report[k]
                for k in ("stage_ms", "host_ms", "e2e_ms", "blobs_per_s", "peak_mem_bytes", "peak_reserved_bytes", "replay_equals_direct", "replay_kernels", "staging_alone", "trace")
            }
            | {"sweeps": {part: {str(w): r for w, r in runs_.items()} for part, runs_ in report["sweeps"].items()}, "card": card}
        )
    )
    log(json.dumps({"prover": prover, "card": card}))
    log(json.dumps({"engine_vs_golden": engine, "card": card}))
    # Host placement on this machine's CPU beside the card's figures.
    log(
        json.dumps(
            {
                "host_placement": {
                    "e2e_ms": host["verify"]["e2e_ms"],
                    "blobs_per_s": host["verify"]["blobs_per_s"],
                    "prover_ms": host["host_ms"],
                    "vectors": host["vectors"],
                    "cpus": os.cpu_count(),
                },
                "card_path": {"e2e_ms": report["e2e_ms"], "blobs_per_s": report["blobs_per_s"], "prover_ms": {k: v for k, v in prover["host_ms"].items() if not k.startswith("golden")}},
                "card": card,
            }
        )
    )
    log(json.dumps({"auto": auto, "vectors_by_placement": vectors, "card": card}))
    log(json.dumps({"device_pairing": pairing, "card": card}))
    log(json.dumps({"sharded": sharded, "distributed": world, "card": card}))
    # The kernels line lists the ports of the repo's TPU kernels, K1-K4, the
    # prover's MSM kernels, M1 and M2, and the device pairing's, P1 (its
    # product; the other op codes are logged above), P2 and P3 at K = 64;
    # the launchers that share their device functions are checked and
    # logged above.
    log(json.dumps({"kernels": [r for r in rows if r["name"].startswith(("K", "M", "P")) or r.get("kernels_line")]}))
    log(nvidia_smi("name,power.limit"))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
