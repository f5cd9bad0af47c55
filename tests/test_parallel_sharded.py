"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(conftest forces the CPU platform with xla_force_host_platform_device_count=8;
SURVEY.md section 4: test sharded paths without a pod).

Shapes are shared across tests (n=16 points, one mesh, one fold) because
every distinct shape costs a full XLA compile set on CPU.
"""

from __future__ import annotations

import random

import jax
import pytest

from kzg_rust_tpu.golden import curve as gc
from kzg_rust_tpu.golden.field import R
from kzg_rust_tpu.parallel import sharded as S

rng = random.Random(0xD15C)

N_POINTS = 16


@pytest.fixture(scope="module")
def sharded_ctx():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = S.default_mesh()
    pts = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, gc.R)) for _ in range(N_POINTS)]
    ctx = S.ShardedMsmContext.build_from_points(pts, mesh, fold=32)
    return ctx, pts


def test_sharded_msm_matches_naive(sharded_ctx):
    ctx, pts = sharded_ctx
    scalars = [rng.randrange(R) for _ in range(N_POINTS)]
    got = S.msm_fixed_base_sharded(ctx, scalars)
    assert got == gc.g1_lincomb_naive(pts, scalars)


def test_sharded_msm_matches_single_chip(sharded_ctx):
    from kzg_rust_tpu.ops import msm as M

    ctx, pts = sharded_ctx
    # fold=64 matches the MsmContext shapes in test_ops_msm.py.
    sc = M.MsmContext.build_from_points(pts, fold=64)
    scalars = [rng.randrange(R) for _ in range(N_POINTS)]
    assert S.msm_fixed_base_sharded(ctx, scalars) == M.msm_fixed_base(sc, scalars)


def test_sharded_barycentric_matches_golden():
    """Domain-axis sharded barycentric == golden scalar evaluation."""
    import jax.numpy as jnp
    import numpy as np

    from kzg_rust_tpu.backends.golden_backend import GoldenBackend
    from kzg_rust_tpu.ops import limbs as L
    from kzg_rust_tpu.ops.fields import FR
    from kzg_rust_tpu.presets import Preset
    from kzg_rust_tpu.settings import KzgSettings
    from kzg_rust_tpu.utils.domain import compute_roots_of_unity

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = S.domain_mesh()
    scale = 6  # 64-wide domain, divisible by the 8-device mesh
    n = 1 << scale
    roots = compute_roots_of_unity(scale)
    settings = KzgSettings(
        preset=Preset(name="t64", field_elements_per_blob=n),
        max_width=n,
        roots_of_unity=roots,
        g1_values=[],
        g2_values=[],
    )
    golden = GoldenBackend()
    b = 2
    evals = [[rng.randrange(R) for _ in range(n)] for _ in range(b)]
    xs = [rng.randrange(R) for _ in range(b)]

    rr = FR.mont_r
    roots_m = jnp.asarray(L.ints_to_limbs(FR.nlimbs, [(w * rr) % R for w in roots]))
    evals_arr = jnp.asarray(
        np.stack([L.ints_to_limbs(FR.nlimbs, e) for e in evals])
    )
    xs_arr = jnp.asarray(L.ints_to_limbs(FR.nlimbs, xs))
    got = L.limbs_to_ints(np.asarray(S.sharded_bary_kernel(roots_m, evals_arr, xs_arr, n, mesh)))
    want = [golden.barycentric_eval(settings, evals[i], xs[i]) for i in range(b)]
    assert got == want


@pytest.mark.slow
def test_sharded_batch_stages_match_golden():
    """Blob-axis sharded batch verification, stages 1 + 2 (device
    decompression + window chain + GLV subgroup checks, then the GLV
    gather/reduce RLC combination) == golden naive lincombs (the scale-out
    path of verify_blob_kzg_proof_batch)."""
    import jax.numpy as jnp
    import numpy as np

    from kzg_rust_tpu.ops import curve as C
    from kzg_rust_tpu.ops import msm as M
    from kzg_rust_tpu.ops import verify_kernels as V

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = S.blobs_mesh()
    d = mesh.devices.size
    n = 2 * d
    commitments = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    proofs = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    comp_rows = []
    for i in range(n):
        comp_rows.append(gc.g1_compress(commitments[i]))
        comp_rows.append(gc.g1_compress(proofs[i]))
    comp = np.frombuffer(b"".join(comp_rows), dtype=np.uint8).reshape(2 * n, 48)
    bases, bases2, flags = S.sharded_batch_points_kernel(jnp.asarray(comp), mesh)
    assert bool(np.asarray(flags)[0]), "valid points flagged as undecodable"
    assert bool(np.asarray(flags)[1]), "subgroup points flagged out of subgroup"

    r_powers = [rng.randrange(R) for _ in range(n)]
    r_times_z = [rng.randrange(R) for _ in range(n)]
    ys = [rng.randrange(R) for _ in range(n)]
    ry = sum(rp * y for rp, y in zip(r_powers, ys)) % R

    out = S.sharded_batch_stage2_kernel(
        bases,
        bases2,
        jnp.asarray(V.stage2_digits(n, r_powers, r_times_z)),
        V.build_generator_table(),
        jnp.asarray(M.recode_signed_digits([ry], 1), dtype=jnp.int32),
        mesh,
    )
    lhs, rhs = C.proj_to_points(np.asarray(out))

    assert lhs == gc.g1_lincomb_naive(proofs, r_powers)
    cmy = [
        gc.g1_sub(commitments[i], gc.g1_mul(gc.G1_GENERATOR, ys[i]))
        for i in range(n)
    ]
    assert rhs == gc.g1_add(
        gc.g1_lincomb_naive(cmy, r_powers), gc.g1_lincomb_naive(proofs, r_times_z)
    )


@pytest.mark.slow
def test_public_api_batch_hits_sharded_kernels(monkeypatch):
    """VERDICT round-1 item 3 done-criterion: a public-API batch call on the
    multi-device CPU mesh must route through the sharded kernels (asserted
    via call counters) and produce the same verdict as the golden backend."""
    import random as _random

    from kzg_rust_tpu.api import Kzg
    from kzg_rust_tpu.backends.golden_backend import GoldenBackend
    from kzg_rust_tpu.backends.jax_backend import JaxBackend
    from kzg_rust_tpu.presets import MINIMAL
    from kzg_rust_tpu.types import Blob
    from kzg_rust_tpu.utils.testing import make_insecure_setup

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")

    monkeypatch.setenv("KZG_TPU_SHARD", "auto")
    monkeypatch.setenv("KZG_TPU_EVAL", "device")

    lrng = _random.Random(0x5A4D)
    settings = make_insecure_setup(MINIMAL)
    golden = GoldenBackend()
    blobs = [
        Blob(
            b"".join(b"\x00" + lrng.randbytes(31) for _ in range(4)),
            bytes_per_blob=MINIMAL.bytes_per_blob,
        )
        for _ in range(4)
    ]
    cs = [Kzg.blob_to_kzg_commitment(b, settings, golden) for b in blobs]
    ps = [Kzg.compute_blob_kzg_proof(b, c, settings, golden) for b, c in zip(blobs, cs)]

    calls = {"points": 0, "bary": 0, "stage2": 0}
    real_points = S.sharded_batch_points_kernel
    real_bary = S.sharded_bary_blobs_kernel
    real_stage2 = S.sharded_batch_stage2_kernel

    def count(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return wrapper

    monkeypatch.setattr(S, "sharded_batch_points_kernel", count("points", real_points))
    monkeypatch.setattr(S, "sharded_bary_blobs_kernel", count("bary", real_bary))
    monkeypatch.setattr(S, "sharded_batch_stage2_kernel", count("stage2", real_stage2))

    jaxbe = JaxBackend()
    ok = Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, jaxbe)
    assert ok is Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, golden) is True
    assert calls == {"points": 1, "bary": 1, "stage2": 1}, calls

    # A wrong pairing must flow through the same sharded path to False.
    swapped = [ps[1], ps[0]] + ps[2:]
    assert Kzg.verify_blob_kzg_proof_batch(blobs, cs, swapped, settings, jaxbe) is False
    assert calls["stage2"] == 2


def test_public_api_prover_hits_sharded_msm(monkeypatch):
    """VERDICT round-2 items 4 + 7 done-criteria: on a multi-device host the
    public-API prover routes ``blob_to_kzg_commitment`` through the
    point-sharded commit kernel, and ``compute_kzg_proof`` reaches both the
    domain-sharded barycentric and the point-sharded MSM — byte-identical to
    the golden backend."""
    import random as _random

    from kzg_rust_tpu.api import Kzg
    from kzg_rust_tpu.backends.golden_backend import GoldenBackend
    from kzg_rust_tpu.backends.jax_backend import JaxBackend
    from kzg_rust_tpu.presets import Preset
    from kzg_rust_tpu.types import Blob, Bytes32
    from kzg_rust_tpu.utils.testing import make_insecure_setup

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")

    monkeypatch.setenv("KZG_TPU_SHARD", "auto")
    monkeypatch.setenv("KZG_TPU_PROVER", "device")
    monkeypatch.setenv("KZG_TPU_EVAL", "device")

    lrng = _random.Random(0xC0117)
    # 16 field elements: wide enough for the MSM context (the n<8 naive
    # fallback mirrors utils.rs:369-371), small enough for CPU-XLA compiles.
    preset = Preset(name="t16", field_elements_per_blob=16)
    settings = make_insecure_setup(preset)
    golden = GoldenBackend()
    blob = Blob(
        b"".join(b"\x00" + lrng.randbytes(31) for _ in range(16)),
        bytes_per_blob=preset.bytes_per_blob,
    )

    calls = {"commit": 0, "msm": 0, "bary": 0}
    real_commit = S.sharded_commit_kernel
    real_msm = S._sharded_msm_kernel
    real_bary = S.sharded_bary_kernel

    def count(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return wrapper

    monkeypatch.setattr(S, "sharded_commit_kernel", count("commit", real_commit))
    monkeypatch.setattr(S, "_sharded_msm_kernel", count("msm", real_msm))
    monkeypatch.setattr(S, "sharded_bary_kernel", count("bary", real_bary))

    jaxbe = JaxBackend()
    c_dev = Kzg.blob_to_kzg_commitment(blob, settings, jaxbe)
    assert bytes(c_dev) == bytes(Kzg.blob_to_kzg_commitment(blob, settings, golden))
    assert calls["commit"] == 1, calls

    z = Bytes32((7).to_bytes(32, "big"))
    proof_dev, y_dev = Kzg.compute_kzg_proof(blob, z, settings, jaxbe)
    proof_gold, y_gold = Kzg.compute_kzg_proof(blob, z, settings, golden)
    assert bytes(proof_dev) == bytes(proof_gold)
    assert bytes(y_dev) == bytes(y_gold)
    assert calls["bary"] >= 1, calls
    assert calls["msm"] >= 1, calls
