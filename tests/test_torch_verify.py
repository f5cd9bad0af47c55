"""The port's verification stages (kzg_rust_tpu_torch.ops.verify_kernels, on
the plain versions of K1-K4) against the JAX package's jitted stage
programs, at the shapes tests/test_batch_pipeline.py already compiles
(4 padded blobs: 8 stage-1 rows, the minimal preset's 4-element blobs).

Inputs come from seeded generators and go through both packages; every
comparison is exact: flags, projective words where the two compute the
same representation, canonical ys, and affine points where the
summation orders differ.
"""

from __future__ import annotations

import random
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import msm as JM
from kzg_rust_tpu.ops import protocol_kernels as JPK
from kzg_rust_tpu.ops import verify_kernels as JV
from kzg_rust_tpu.presets import MINIMAL as J_MINIMAL
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.errors import BadArgs
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P, R, fp_sqrt
from kzg_rust_tpu_torch.ops import curve as C
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import msm as M
from kzg_rust_tpu_torch.ops import protocol_kernels as PKT
from kzg_rust_tpu_torch.ops import verify_kernels as V
from kzg_rust_tpu_torch.presets import MAINNET, MINIMAL
from kzg_rust_tpu_torch.utils.domain import compute_roots_of_unity
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

rng = random.Random(0x7E571)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _non_subgroup_point():
    while True:
        x = rng.randrange(P)
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return (x, y)


def _valid_rows(k):
    return [gc.g1_compress(gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R))) for _ in range(k)]


INF = b"\xc0" + b"\x00" * 47
X_OVER_P = bytes([0x80 | (P >> 376)]) + P.to_bytes(48, "big")[1:]


@pytest.fixture(scope="module")
def rows():
    valid = _valid_rows(6) + [INF, INF]
    bad = list(valid)
    bad[1] = b"\x11" * 48  # compression flag clear
    bad[2] = gc.g1_compress(_non_subgroup_point())
    bad[3] = X_OVER_P  # x == p: not canonical
    bad[4] = b"\xc0" + b"\x00" * 46 + b"\x01"  # infinity flag with a nonzero payload
    bad[5] = bytes([valid[5][0] ^ 0x20]) + valid[5][1:]  # the other square root
    return valid, bad


def _comp(rows_):
    return np.frombuffer(b"".join(rows_), np.uint8).reshape(len(rows_), 48).copy()


@pytest.fixture(scope="module")
def jax_stage1(rows):
    """The JAX package's stage 1 on both 8-row inputs (one compiled program)."""
    return [tuple(np.asarray(t) for t in JV.batch_points_kernel(jnp.asarray(_comp(r)))) for r in rows]


def test_batch_points_matches_jax(rows, jax_stage1):
    for rows_, (jb, jb2, jflags) in zip(rows, jax_stage1):
        bases, bases2, flags = V.batch_points(torch.from_numpy(_comp(rows_)))
        assert flags.tolist() == jflags.tolist()
        # Same decompression and doubling formulas: the same projective words.
        assert torch.equal(bases, JS.points_from_jax(jb))
        assert torch.equal(bases2, JS.points_from_jax(jb2))
    assert jax_stage1[0][2].tolist() == [1, 1]
    assert jax_stage1[1][2].tolist() == [0, 0]


def test_stage1_row_flags_match_golden(rows):
    """Per row: decode flags against golden g1_uncompress, and the subgroup
    check against golden g1_in_subgroup; bases against golden multiples."""
    _, bad = rows
    comp = torch.from_numpy(_comp(bad))
    points, ok = V.g1_uncompress_points(comp)
    want_ok, want_pts = [], []
    for r in bad:
        try:
            want_pts.append(gc.g1_uncompress(r))
            want_ok.append(True)
        except BadArgs:
            want_pts.append(None)
            want_ok.append(False)
    assert ok.tolist() == want_ok
    got = C.proj_to_points(points)
    assert [g for g, k in zip(got, want_ok) if k] == [p for p, k in zip(want_pts, want_ok) if k]
    bases, bases2 = V.bases_chain(points)
    sub = V.subgroup_check_from_bases(points, bases, bases2)
    for i, k in enumerate(want_ok):
        if k:
            assert sub[i].item() == gc.g1_in_subgroup(want_pts[i])
    j = 5
    assert C.proj_to_points(bases[j][:1]) == [gc.g1_mul_unsafe(want_pts[0], 4**j)]
    assert C.proj_to_points(bases2[j][:1]) == [gc.g1_mul_unsafe(want_pts[0], 2 * 4**j)]


def _blob_bytes(n_blobs, fe, noncanonical_at=None):
    data = bytearray()
    for b in range(n_blobs):
        for i in range(fe):
            data += (b"\xff" * 32) if (b, i) == noncanonical_at else (b"\x00" + rng.randbytes(31))
    return np.frombuffer(bytes(data), np.uint8).reshape(n_blobs, fe, 32).copy()


@pytest.mark.parametrize("noncanonical_at", [None, (2, 1)], ids=["canonical", "noncanonical"])
def test_bary_matches_jax_minimal(noncanonical_at):
    """Blob ingest, canonicality flag and the barycentric evaluation on the
    minimal preset, with the port's own FrContext and with the JAX
    package's carried over by jax_state."""
    jset = j_make_insecure_setup(J_MINIMAL)
    jctx = JPK.FrContext.build(jset)
    blobs = _blob_bytes(4, MINIMAL.field_elements_per_blob, noncanonical_at)
    xs = [rng.randrange(R) for _ in range(4)]
    jys, jok = JV.bary_batch_from_bytes_kernel(
        jctx.n, jctx.roots_m, jctx.roots_m2, jctx.inv_n_m, jnp.asarray(blobs), jnp.asarray(JL.ints_to_limbs(22, xs))
    )
    ctx = PKT.FrContext.build(make_insecure_setup(MINIMAL), "cpu")
    carried = JS.fr_context_from_jax(jctx.n, np.asarray(jctx.roots_m), np.asarray(jctx.roots_m2), np.asarray(jctx.inv_n_m))
    for c in (ctx, carried):
        ys, ok = V.bary_batch_from_bytes(c, torch.from_numpy(blobs), L.to_device(L.FR, xs, "cpu"))
        assert bool(ok) == bool(jok) == (noncanonical_at is None)
        if noncanonical_at is None:
            assert L.words_to_ints(ys) == JL.limbs_to_ints(np.asarray(jys))
    assert torch.equal(carried.roots_m2, ctx.roots_m2) and torch.equal(carried.inv_n_m, ctx.inv_n_m)


def test_bary_matches_golden_mainnet():
    """Two mainnet-width blobs (4096 elements) against the golden
    barycentric evaluation."""
    settings = types.SimpleNamespace(preset=MAINNET, roots_of_unity=compute_roots_of_unity(12))
    blobs = _blob_bytes(2, 4096)
    xs = [rng.randrange(R) for _ in range(2)]
    ctx = PKT.FrContext.build(settings, "cpu")
    ys, ok = V.bary_batch_from_bytes(ctx, torch.from_numpy(blobs), L.to_device(L.FR, xs, "cpu"))
    assert bool(ok)
    golden = GoldenBackend()
    for b in range(2):
        evals = [int.from_bytes(blobs[b, i].tobytes(), "big") for i in range(4096)]
        assert L.words_to_ints(ys[b : b + 1]) == [golden.barycentric_eval(settings, evals, xs[b])]


def test_stage2_matches_jax(rows, jax_stage1):
    """The RLC combination over the JAX package's own stage-1 bases and
    generator table (carried by jax_state) and over the port's own table:
    the same affine points as batch_stage2_kernel."""
    jb, jb2, _ = jax_stage1[0]
    n = 4
    r_powers = [rng.randrange(R) for _ in range(n)]
    r_times_z = [rng.randrange(R) for _ in range(n)]
    digits = V.stage2_digits(n, r_powers, r_times_z)
    assert (digits == JV.stage2_digits(n, r_powers, r_times_z)).all()
    sy = M.recode_signed_digits([rng.randrange(R)], 1)
    jtable = JV.build_generator_table()
    want = JV.batch_stage2_kernel(
        jnp.asarray(jb), jnp.asarray(jb2), jnp.asarray(digits), jtable, jnp.asarray(sy, dtype=jnp.int32)
    )
    want_aff = C.proj_to_points(JS.points_from_jax(np.asarray(want)))
    table = V.build_generator_table("cpu")
    assert C.proj_to_points(table.reshape(-1, 3, 12)) == C.proj_to_points(
        JS.gen_table_from_jax(np.asarray(jtable)).reshape(-1, 3, 12)
    )
    for t in (JS.gen_table_from_jax(np.asarray(jtable)), table):
        got = V.batch_stage2(
            JS.points_from_jax(jb), JS.points_from_jax(jb2), torch.from_numpy(digits), t, torch.from_numpy(sy)
        )
        assert C.proj_to_points(got) == want_aff
    assert (M.recode_signed_digits([5, R - 1], 2) == JM.recode_signed_digits([5, R - 1], 2)).all()
