#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kzg_rust_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, any failure of which exits non-zero without the final line:

1. build the CUDA kernels from kzg_rust_tpu_torch/csrc/ (nvcc, sm_90a) and
   print the build seconds, what ptxas reported, the SASS instructions of
   one Fp product of each core (where the toolkit has cuobjdump), and the
   card's name and power limit;
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, exactly, edge lanes included, and time
   both with CUDA events; the K4 chain also against as many one-step K4
   launches;
3. drive the main path, ``Kzg.verify_blob_kzg_proof_batch`` through
   ``TorchBackend()`` on the mainnet setup: the 22 mainnet batch vectors,
   then batches of n = 64 and n = 4096 sampled (numpy seed) from the six
   valid ``verify_blob_kzg_proof`` vectors, with five outcome lanes each
   (valid, swapped proof, non-canonical blob, malformed point, non-subgroup
   point; the n = 64 lanes cross-checked against the golden backend), the
   launch counts of one valid batch, stage times and peak memory;
4. check that every kernel of the path launched in the n = 64 batch and
   that the window-base chain was one launch at both n, and print the
   report lines and the ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside this script, it exits 2 and prints no result.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import glob
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0x5EED
BAD_FROM_END = 3  # the corrupted lane sits near the end of the batch
BATCH_SIZES = (64, 4096)  # a block's batch, and bulk sync; the first is cross-checked on golden
# Built and held against their plain versions, but the verify path does not
# launch them: the barycentric domain sum runs in kzg_fr_sum_rows, and the
# window-base chain runs K4 as kzg_proj_double_chain, one launch for all its
# doublings (kzg_proj_double is K4 alone, for checking and timing).
OFF_PATH = {"kzg_fr_add", "kzg_proj_double"}
# Phase 2 shapes, each one the main path gives the kernel at n = 4096 or 64:
# K1 at stage 1's width (2 * 4096 points); K2 and the Fr launchers at a
# product-tree level of the barycentric evaluation (4096 blobs x 64); the
# domain sum at n = 64 (4096 rows of 64 blobs); K3 at the subgroup check's
# first tree level (8 of its 17 window rows x 8192 points) and at stage 2's
# widest, the right-hand tree's first level (66 windows x 4096 blobs x 4
# lanes, halved); K4 and its chain at the window-base chain's widths
# (n = 4096 and n = 64).
SHAPES = {"fp": 8192, "fr": 262144, "sum": (4096, 64), "add": (65536, 540672), "double": (8192, 128)}

# Published H100 SXM peaks (NVIDIA data sheet) and the integer pipe rate
# (CUDA C++ Programming Guide, arithmetic throughput table, compute
# capability 9.0: 64 32-bit integer multiply-adds per clock per SM).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
# Fp products in a complete add and in a doubling as the curve kernels take
# them: RCB's products by b3 = 12 are adds there (the same canonical value),
# so 14 - 2 and 9 - 1.
ADD_PRODUCTS, DOUBLE_PRODUCTS = 12, 8


# Three kernels that differ only in what they do between loading two Fp
# elements and storing one: nothing (an xor), K1's product, K3/K4's product.
SASS_PROBE = r"""
#include "field.cuh"
using namespace kzg;
#define PROBE(name, body)                                                               \
  extern "C" __global__ void name(const uint32_t* a, const uint32_t* b, uint32_t* r) { \
    uint32_t x[12], y[12], z[12];                                                      \
    load_words<12>(x, a + 12 * threadIdx.x);                                           \
    load_words<12>(y, b + 12 * threadIdx.x);                                           \
    body;                                                                              \
    store_words<12>(r + 12 * threadIdx.x, z);                                          \
  }
PROBE(probe_load_store, for (int j = 0; j < 12; j++) z[j] = x[j] ^ y[j])
PROBE(probe_mont_mul, mont_mul<Fp>(z, x, y))
PROBE(probe_fp_mont_mul, fp_mont_mul(z, x, y))
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

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 3) / reps


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


def check_kernels(device, sm_clock_hz: float, sms: int) -> list[dict]:
    import numpy as np
    import torch

    from kzg_rust_tpu_torch.golden.field import P, R
    from kzg_rust_tpu_torch.ops import curve as C
    from kzg_rust_tpu_torch.ops import limbs as L
    from kzg_rust_tpu_torch.ops import verify_kernels as V

    rng = np.random.default_rng(SEED)
    imad_s = sms * IMAD_PER_CLOCK_PER_SM * sm_clock_hz
    rows = []

    def bound(nbytes: float, int_ops: float):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, int_ops / imad_s * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def record(name, kernel, plain, args, source, replaces, nbytes, int_ops, reps, keep=True):
        """Hold ``kernel`` against ``plain`` on ``args``, time both and return
        the row, kept in ``rows`` unless ``keep`` is false."""
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        g64 = got.to(torch.int64) & 0xFFFFFFFF
        w64 = want.to(torch.int64) & 0xFFFFFFFF
        err = int((g64 - w64).abs().max().item()) if got.numel() else 0
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain version (max |diff| {err})")
        call_ms = cuda_ms(lambda: kernel(*args), reps)
        ms = graph_ms(lambda: kernel(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        bms, by = bound(nbytes, int_ops)
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
        }
        log(
            f"kernel {name}: equal to plain at {list(args[0].shape)}; {ms:.4f} ms on the card "
            f"(CUDA graph replay; {call_ms:.4f} ms per call with the host), plain {plain_ms:.2f} ms, "
            f"bound {bms:.4f} ms by {by}"
        )
        if keep:
            rows.append(row)
        return row

    def mont_products(nw):  # 32-bit multiply-adds of one CIOS product: 2 per word product
        return 2 * (2 * nw * nw + nw)

    fsrc = "kzg_rust_tpu_torch/csrc/field_kernels.cu"
    csrc = "kzg_rust_tpu_torch/csrc/curve_kernels.cu"
    pk = "kzg_rust_tpu/ops/pallas_kernels.py"

    def field_operands(spec, n):
        a = random_field(rng, spec.modulus, n)
        b = random_field(rng, spec.modulus, n)
        a[:3] = [0, spec.modulus - 1, 1]  # edge rows: 0*0, (N-1)^2, 1*x
        b[:2] = [0, spec.modulus - 1]
        return L.to_device(spec, a, device), L.to_device(spec, b, device)

    for spec, n, kname, line in ((L.FP, SHAPES["fp"], "K1", 248), (L.FR, SHAPES["fr"], "K2", 252)):
        a, b = field_operands(spec, n)
        nw = spec.nwords
        record(
            f"{kname} kzg_{spec.name}_mont_mul",
            lambda x, y, s=spec: L.mont_mul(s, x, y),
            lambda x, y, s=spec: L.mont_mul_plain(s, x, y),
            (a, b),
            fsrc,
            f"{pk}:{line}",
            3 * n * nw * 4,
            n * mont_products(nw),
            50,
        )
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
    k, inner = SHAPES["sum"]
    terms = L.to_device(L.FR, random_field(rng, R, k * inner), device).reshape(k, inner, 8)
    record(
        "kzg_fr_sum_rows",
        lambda x: L.sum_mod(L.FR, x),
        lambda x: L.sum_mod_plain(L.FR, x),
        (terms,),
        fsrc,
        "kzg_rust_tpu/ops/limbs.py:482 (sum_mont_redc, an XLA op)",
        terms.numel() * 4 + inner * 8 * 4,
        k * inner * 3 * 8,
        50,
    )

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

    # The kernels line: K3 at the widest launch and K4 as the chain, each
    # with its narrower shape beside it.
    add_rows[1]["at_narrow"] = add_rows[0]
    dbl_rows[0]["at_narrow"] = dbl_rows[1]
    rows += [add_rows[1], dbl_rows[0]]
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------


def read_vector(path: str):
    """The vectors' YAML is flow lists of quoted hex strings and one
    true/false/null output; read with a regular expression."""
    with open(path) as fh:
        text = fh.read()
    inp, out = text.split("\noutput:")
    fields = {}
    for m in re.finditer(r"(\w+):\s*(\[[^\]]*\]|'[^']*')", inp):
        strs = re.findall(r"'([^']*)'", m.group(2))
        fields[m.group(1)] = strs if m.group(2).startswith("[") else strs[0]
    return fields, {"true": True, "false": False, "null": None}[out.strip()]


def out_of_subgroup_compressed(rng) -> bytes:
    from kzg_rust_tpu_torch.golden import curve as gc
    from kzg_rust_tpu_torch.golden.field import P, fp_sqrt

    while True:
        x = rng.randrange(P)
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return gc.g1_compress((x, y))


def main_path(backend) -> dict:
    import numpy as np
    import torch

    from kzg_rust_tpu_torch import Blob, Bytes48, Kzg, KzgError
    from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
    from kzg_rust_tpu_torch.errors import BadArgs
    from kzg_rust_tpu_torch.messages import (
        MSG_INVALID_BYTES32,
        MSG_INVALID_COMPRESSED_G1,
        MSG_NOT_IN_SUBGROUP,
    )
    from kzg_rust_tpu_torch.ops import _build

    t0 = time.perf_counter()
    settings = Kzg.load_trusted_setup_file(os.path.join(ROOT, "data", "trusted_setup.txt"))
    log(f"main: mainnet trusted setup loaded in {time.perf_counter() - t0:.2f} s")
    golden = GoldenBackend()
    vec = os.path.join(ROOT, "tests", "vectors")

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
    log(f"main: all {len(files)} mainnet verify_blob_kzg_proof_batch vectors pass")

    # Valid triples: the six correct-proof verify_blob_kzg_proof vectors.
    triples = []
    for f in sorted(glob.glob(os.path.join(vec, "verify_blob_kzg_proof", "*", "*correct_proof_*", "data.yaml"))):
        if "incorrect" in f:
            continue
        inp, expected = read_vector(f)
        if expected is not True:
            raise AssertionError(f"{f}: a correct-proof vector that does not verify")
        triples.append((Blob.from_hex(inp["blob"]), Bytes48.from_hex(inp["commitment"]), Bytes48.from_hex(inp["proof"])))
    if len(triples) != 6:
        raise AssertionError(f"expected 6 valid triples, found {len(triples)}")

    nrng = np.random.default_rng(SEED)
    prng = random.Random(SEED)
    sub_point = Bytes48(out_of_subgroup_compressed(prng))
    report = {"lanes": {}, "launches": {}, "stage_ms": {}, "host_ms": {}, "e2e_ms": {}, "blobs_per_s": {}}

    small, large = BATCH_SIZES[0], BATCH_SIZES[-1]
    for n in BATCH_SIZES:
        pick = nrng.integers(0, len(triples), size=n)
        blobs = [triples[i][0] for i in pick]
        cs = [triples[i][1] for i in pick]
        ps = [triples[i][2] for i in pick]
        bad = n - BAD_FROM_END
        # A valid proof of another blob (two of the six share the infinity proof).
        swapped = list(ps)
        swapped[bad] = next(t[2] for t in triples if t[2] != ps[bad])
        noncanon = list(blobs)
        noncanon[bad] = Blob(b"\xff" * 32 + bytes(blobs[bad])[32:])
        malformed = list(cs)
        malformed[bad] = Bytes48(b"\x11" * 48)
        nonsub = list(cs)
        nonsub[bad] = sub_point
        lanes = {
            "valid": ((blobs, cs, ps), True),
            "swapped_proof": ((blobs, cs, swapped), False),
            "noncanonical_blob": ((noncanon, cs, ps), MSG_INVALID_BYTES32),
            "malformed_point": ((blobs, malformed, ps), MSG_INVALID_COMPRESSED_G1),
            "non_subgroup_point": ((blobs, nonsub, ps), MSG_NOT_IN_SUBGROUP),
        }
        backends = [("torch", backend)] + ([("golden", golden)] if n == small else [])
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
                    raise AssertionError(f"n={n} lane {lane} on {bname}: got {outcome!r}, expected {expect!r}")
            report["lanes"][f"{n}/{lane}"] = "ok" + (" (golden agrees)" if n == small else "")
        log(f"main: n={n}: the five outcome lanes are right" + (" and agree with the golden backend" if n == small else ""))

        # Launch counts of one valid batch: counts set to 0 just before, read just after.
        _build.reset_launches()
        valid = Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, backend)
        torch.cuda.synchronize()
        report["launches"][n] = dict(_build.LAUNCHES)
        if valid is not True:
            raise AssertionError(f"n={n}: the valid batch did not verify")
        log(f"main: n={n}: launches in one valid batch: {json.dumps(report['launches'][n])}")

        # Stage times and end to end, median of 3 runs.
        if n == large:
            torch.cuda.reset_peak_memory_stats()
        stages, e2e, host = {s: [] for s in ("stage1", "bary", "stage2")}, [], {}
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            valid = Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, backend)
            e2e.append((time.perf_counter() - t) * 1e3)
            if valid is not True:
                raise AssertionError(f"n={n}: the valid batch did not verify")
            for s, v in backend.stage_ms().items():
                stages[s].append(v)
            for s, v in backend.host_ms.items():
                host.setdefault(s, []).append(v)
        if n == large:
            report["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        report["stage_ms"][n] = {s: statistics.median(v) for s, v in stages.items()}
        report["e2e_ms"][n] = statistics.median(e2e)
        report["host_ms"][n] = {s: statistics.median(v) for s, v in host.items()}
        report["blobs_per_s"][n] = n / (report["e2e_ms"][n] / 1e3)
        log(
            f"main: n={n}: stage1 {report['stage_ms'][n]['stage1']:.2f} ms, bary "
            f"{report['stage_ms'][n]['bary']:.2f} ms, stage2 {report['stage_ms'][n]['stage2']:.2f} ms "
            f"(CUDA events, median of 3); end to end {report['e2e_ms'][n]:.1f} ms = "
            f"{report['blobs_per_s'][n]:.1f} blobs/s (host clock, median of 3)"
        )
        log(f"main: n={n}: host ms between steps (median of 3): {json.dumps(report['host_ms'][n])}")
    log(f"main: peak device memory over the n={large} runs: {report['peak_mem_bytes']} bytes")
    return report


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
    sys.path.insert(0, ROOT)
    # Everything the run writes stays inside the checkout.
    os.environ.setdefault("KZG_TORCH_CACHE_DIR", os.path.join(ROOT, "build", "setup_cache"))

    from kzg_rust_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 1: build.
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.BUILD_INFO)} sources in parallel")
    for src, info in _build.BUILD_INFO.items():
        kernel = spills = None
        for line in info["ptxas"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # e.g. ..13binary_kernelIN3kzg2FpELi0EEEv..: binary_kernel Fp 0
                kernel = " ".join(filter(None, re.findall(r"\d+([a-z_]+_kernel)I?(?:N3kzg2(F[pr])E)?(?:Li(\d+)E)?", m.group(1))[-1]))
            elif "spill stores" in line:
                spills = line.strip()
            elif "registers" in line and kernel:
                log(f"build: {src} {kernel}: {line.split(':')[-1].strip()}; {spills}")
    sass = sass_counts()
    if sass is None:
        log("sass: no cuobjdump in the CUDA toolkit; instructions per Fp product not counted")
    else:
        base = sass["probe_load_store"]
        log(
            f"sass: instructions per Fp product on sm_90a: mont_mul<Fp> (K1) {sass['probe_mont_mul'] - base}, "
            f"fp_mont_mul (K3, K4) {sass['probe_fp_mont_mul'] - base} (probe kernels {json.dumps(sass)}, "
            f"less the load/store probe's {base})"
        )
    card = nvidia_smi("name,power.limit")
    log(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f"bounds: {sms} SMs at the max SM clock {clock_mhz:.0f} MHz, {IMAD_PER_CLOCK_PER_SM} IMAD/clock/SM, {HBM_BYTES_PER_S / 1e12} TB/s")

    # Phase 2: kernels against their plain versions.
    rows = check_kernels(device, clock_mhz * 1e6, sms)

    # Phase 3: the main path.
    from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend

    report = main_path(TorchBackend(time_stages=True))

    # Phase 4: report.
    small, large = BATCH_SIZES[0], BATCH_SIZES[-1]
    for row in rows + [r["at_narrow"] for r in rows if "at_narrow" in r]:
        entry = row["name"].split()[-1]
        row["launches"] = report["launches"][small][entry]
        row[f"launches_n{large}"] = report["launches"][large][entry]
    missing = [e for e, c in report["launches"][small].items() if c == 0 and e not in OFF_PATH]
    if missing:
        raise AssertionError(f"kernels of the path never launched by the n={small} batch: {missing}")
    for n in BATCH_SIZES:  # the window-base chain is one launch, with no one-step K4 beside it
        got = (report["launches"][n]["kzg_proj_double_chain"], report["launches"][n]["kzg_proj_double"])
        if got != (1, 0):
            raise AssertionError(f"n={n}: chain and one-step K4 launches {got}, expected (1, 0)")
    for row in rows:
        log(f"launches: {row['name']}: {row['launches']} in one n={small} batch, {row[f'launches_n{large}']} in one n={large} batch")
    log(json.dumps({"stage_ms": report["stage_ms"], "host_ms": report["host_ms"], "e2e_ms": report["e2e_ms"], "blobs_per_s": report["blobs_per_s"], "peak_mem_bytes": report["peak_mem_bytes"], "card": card}))
    # The kernels line lists the ports of the repo's TPU kernels, K1-K4; the
    # launchers that share their device functions are checked and logged above.
    log(json.dumps({"kernels": [r for r in rows if r["name"].startswith("K")]}))
    log(nvidia_smi("name,power.limit"))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
