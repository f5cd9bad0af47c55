"""The port's multi-device paths (kzg_rust_tpu_torch.parallel) on meshes of
CPU devices, where every shard runs the kernels' plain versions.

``parallel/sharded.py`` on meshes of ``["cpu"] * D`` (D = 2 and 4) against
the JAX package's ``parallel/sharded.py`` on its 8 virtual CPU devices and
against the port's unsharded path: the point-split MSM and commit, the
domain-split barycentric evaluation and the blob-split batch stages, then
the public API reaching them through a patched mesh method.
``parallel/distributed.py`` in a gloo world of one rank and in a world of
two processes, against the JAX package's 2 x 4 (host, chip) mesh.  Results
compare as affine points and canonical integers: projective words differ
with the order of the adds.

The JAX shapes are those of tests/test_parallel_sharded.py and
tests/test_parallel_distributed.py (16 setup points, 16 and 8 blobs, a
64-wide domain, the minimal and 16-point presets), so the persistent compile
cache usually holds them.  A shard's context costs as much to build on the
CPU as the whole table (the chain's steps, not the width, set the cost), so
the 4-shard MSM contexts are slices of the unsharded table, which the
2-shard build is held against word for word.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import random
import socket
import subprocess
import sys
from gc import collect as collect_garbage

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kzg_rust_tpu.api import Kzg as JKzg
from kzg_rust_tpu.backends.jax_backend import JaxBackend
from kzg_rust_tpu.ops import curve as JC
from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import verify_kernels as JV
from kzg_rust_tpu.ops.fields import FR as JFR
from kzg_rust_tpu.parallel import distributed as JD
from kzg_rust_tpu.parallel import sharded as JS
from kzg_rust_tpu.presets import MINIMAL as J_MINIMAL
from kzg_rust_tpu.presets import Preset as JPreset
from kzg_rust_tpu.types import Blob as JBlob
from kzg_rust_tpu.types import Bytes32 as JBytes32
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch import Blob, Bytes32, Kzg
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P, R, fp_sqrt
from kzg_rust_tpu_torch.ops import curve as C
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import msm as M
from kzg_rust_tpu_torch.ops import prover_kernels as PR
from kzg_rust_tpu_torch.ops import protocol_kernels as PK
from kzg_rust_tpu_torch.ops import verify_kernels as V
from kzg_rust_tpu_torch.parallel import distributed as D
from kzg_rust_tpu_torch.parallel import sharded as S
from kzg_rust_tpu_torch.presets import MINIMAL, Preset
from kzg_rust_tpu_torch.settings import KzgSettings
from kzg_rust_tpu_torch.utils.domain import compute_roots_of_unity
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

from .conftest import REPO_ROOT

rng = random.Random(0x5A4D)
T16 = Preset(name="t16", field_elements_per_blob=16)
J_T16 = JPreset(name="t16", field_elements_per_blob=16)
SHARDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _worker_resources():
    """One intra-op thread (the plain versions are many small ops); at the
    end the module's JAX programs are dropped and the heap trimmed, as
    tests/test_torch_msm.py does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    collect_garbage()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


def cpu_mesh(d: int) -> list:
    return [torch.device("cpu")] * d


def affine(points) -> list:
    return C.proj_to_points(torch.stack(list(points)).cpu())


def _blob(n: int) -> bytes:
    return b"".join(b"\x00" + rng.randbytes(31) for _ in range(n))


# ---------------------------------------------------------------------------
# The point axis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def t16():
    """The 16-point preset in both packages (the same tau), its unsharded
    MSM context, the 2-shard context built by ``build`` and the 4-shard one
    sliced from the unsharded table."""
    settings, jsettings = make_insecure_setup(T16), j_make_insecure_setup(J_T16)
    full = M.MsmContext.build(settings, "cpu")
    sliced = [
        M.MsmContext(4, full.table[:, :, 4 * k : 4 * k + 4], full.inf_mask[4 * k : 4 * k + 4], M.msm_config(4, "cpu"))
        for k in range(4)
    ]
    ctxs = {1: full, 2: S.ShardedMsmContext.build(settings, cpu_mesh(2)), 4: S.ShardedMsmContext(16, sliced, cpu_mesh(4))}
    return settings, jsettings, ctxs


@pytest.fixture(scope="module")
def jax_t16(t16):
    """The JAX backend's point-split context on its 8 devices, and its
    public-API commitment and proof of one blob (the shapes of
    test_public_api_prover_hits_sharded_msm)."""
    _, jsettings, _ = t16
    blob = _blob(16)
    saved = {k: os.environ.get(k) for k in ("KZG_TPU_SHARD", "KZG_TPU_PROVER", "KZG_TPU_EVAL")}
    os.environ.update(KZG_TPU_SHARD="auto", KZG_TPU_PROVER="device", KZG_TPU_EVAL="device")
    try:
        jax_be = JaxBackend()
        ctx = jax_be._msm_ctx(jsettings)
        assert isinstance(ctx, JS.ShardedMsmContext)
        jblob = JBlob(blob, bytes_per_blob=J_T16.bytes_per_blob)
        z = JBytes32((7).to_bytes(32, "big"))
        commitment = bytes(JKzg.blob_to_kzg_commitment(jblob, jsettings, jax_be))
        proof, y = JKzg.compute_kzg_proof(jblob, z, jsettings, jax_be)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"ctx": ctx, "blob": blob, "commitment": commitment, "proof": (bytes(proof), bytes(y))}


def test_sharded_build_is_the_table_split(t16):
    """The 2-shard build makes, shard by shard, the unsharded table's words
    (the build is pointwise along the point axis)."""
    _, _, ctxs = t16
    full, sharded = ctxs[1], ctxs[2]
    for k, shard in enumerate(sharded.shards):
        assert torch.equal(shard.table, full.table[:, :, 8 * k : 8 * k + 8])
        assert torch.equal(shard.inf_mask, full.inf_mask[8 * k : 8 * k + 8])


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_msm(d, t16, jax_t16):
    settings, _, ctxs = t16
    scalars = [rng.randrange(R) for _ in range(16)]
    scalars[5] = 0
    got = S.msm_fixed_base_sharded(ctxs[d], scalars)
    assert got == M.msm_fixed_base(ctxs[1], scalars)
    assert got == JS.msm_fixed_base_sharded(jax_t16["ctx"], scalars)
    assert got == gc.g1_lincomb_naive(settings.g1_values, scalars)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_commit(d, t16, jax_t16):
    """The commitment of a blob and its canonicality flag, the element axis
    split with the table: the unsharded commit's point, the JAX point-split
    commit's bytes; an element >= r clears the flag on any shard."""
    _, _, ctxs = t16
    blob = torch.from_numpy(np.frombuffer(jax_t16["blob"], dtype=np.uint8).reshape(16, 32).copy())
    point, ok = S.sharded_commit(ctxs[d], blob)
    want, want_ok = PR.commit(ctxs[1], blob)
    assert bool(ok) and bool(want_ok)
    assert affine([point]) == affine([want])
    assert gc.g1_compress(affine([point])[0]) == jax_t16["commitment"]
    bad = blob.clone()
    bad[15] = 0xFF  # in the last shard
    assert not bool(S.sharded_commit(ctxs[d], bad)[1])


# ---------------------------------------------------------------------------
# The domain axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_barycentric(d):
    """A 64-wide domain and two evaluation points (the shapes of
    test_sharded_barycentric_matches_golden): the JAX domain-split kernel,
    the port's unsharded evaluation and the golden one agree."""
    scale, b = 6, 2
    n = 1 << scale
    roots = compute_roots_of_unity(scale)
    settings = KzgSettings(preset=Preset(name="t64", field_elements_per_blob=n), max_width=n, roots_of_unity=roots, g1_values=[], g2_values=[])
    evals = [[rng.randrange(R) for _ in range(n)] for _ in range(b)]
    xs = [rng.randrange(R) for _ in range(b)]
    evals_t = torch.from_numpy(np.stack([L.ints_to_words(L.FR.nwords, e) for e in evals], axis=1))  # [n, B, 8]
    xs_t = torch.from_numpy(L.ints_to_words(L.FR.nwords, xs))
    got = L.words_to_ints(S.sharded_bary(S.ShardedFrContext.build(settings, cpu_mesh(d)), evals_t, xs_t))
    assert got == L.words_to_ints(V.bary_batch(PK.FrContext.build(settings, "cpu"), evals_t, xs_t))
    rr = JFR.mont_r
    roots_m = jnp.asarray(JL.ints_to_limbs(JFR.nlimbs, [(w * rr) % R for w in roots]))
    jevals = jnp.asarray(np.stack([JL.ints_to_limbs(JFR.nlimbs, e) for e in evals]))
    jxs = jnp.asarray(JL.ints_to_limbs(JFR.nlimbs, xs))
    assert got == JL.limbs_to_ints(np.asarray(JS.sharded_bary_kernel(roots_m, jevals, jxs, n, JS.domain_mesh())))
    golden = GoldenBackend()
    assert got == [golden.barycentric_eval(settings, evals[i], xs[i]) for i in range(b)]


# ---------------------------------------------------------------------------
# The blob axis
# ---------------------------------------------------------------------------


def _batch_points(n: int, bad_row: int | None = None):
    """n blobs' commitments and proofs (random subgroup points), their [2n,
    48] blob-major compressed rows, and random RLC scalars and ys; with
    ``bad_row`` that row becomes a point off the subgroup."""
    commitments = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    proofs = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    rows = []
    for i in range(n):
        rows += [gc.g1_compress(commitments[i]), gc.g1_compress(proofs[i])]
    r_powers = [rng.randrange(R) for _ in range(n)]
    r_times_z = [rng.randrange(R) for _ in range(n)]
    ys = [rng.randrange(R) for _ in range(n)]
    ry = sum(rp * y for rp, y in zip(r_powers, ys)) % R
    comp = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(2 * n, 48)
    return commitments, proofs, comp, r_powers, r_times_z, ry


@pytest.fixture(scope="module")
def batch16():
    """16 blobs (test_sharded_batch_stages_match_golden's shapes): the
    inputs, the port's unsharded stage 1 and the JAX blob-split stages."""
    commitments, proofs, comp, r_powers, r_times_z, ry = _batch_points(16)
    digits = V.stage2_digits(16, r_powers, r_times_z)
    sy = M.recode_signed_digits([ry], 1)
    mesh = JS.blobs_mesh()
    jb1, jb2, jflags = JS.sharded_batch_points_kernel(jnp.asarray(comp), mesh)
    jout = JS.sharded_batch_stage2_kernel(jb1, jb2, jnp.asarray(digits), JV.build_generator_table(), jnp.asarray(sy, dtype=jnp.int32), mesh)
    comp_t = torch.from_numpy(comp.copy())
    return {
        "comp": comp_t,
        "digits": torch.from_numpy(digits),
        "sy": torch.from_numpy(sy),
        "unsharded": V.batch_points(comp_t),
        "jax_flags": np.asarray(jflags).tolist(),
        "jax_out": JC.proj_to_points(np.asarray(jout)),
        "golden": (gc.g1_lincomb_naive(proofs, r_powers), commitments, proofs, r_powers, r_times_z, ry),
    }


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_batch_stages(d, batch16):
    """Stage 1 and stage 2 with the blobs split over d shards: the flags and
    the two points of the unsharded stages, of the JAX blob-split stages on
    8 devices, and of the golden lincombs."""
    mesh = cpu_mesh(d)
    bases, bases2, flags = S.sharded_batch_points(batch16["comp"], mesh)
    assert len(bases) == len(bases2) == d and bases[0].shape[1] == 32 // d
    assert flags.tolist() == batch16["unsharded"][2].tolist() == batch16["jax_flags"] == [1, 1]
    gen = V.build_generator_table("cpu")
    out = S.sharded_batch_stage2(bases, bases2, batch16["digits"], gen, batch16["sy"], mesh)
    b1, b2, _ = batch16["unsharded"]
    want = C.proj_to_points(V.batch_stage2(b1, b2, batch16["digits"], gen, batch16["sy"]))
    lhs_gold, commitments, proofs, r_powers, r_times_z, ry = batch16["golden"]
    assert C.proj_to_points(out) == want == batch16["jax_out"]
    rhs_gold = gc.g1_add(gc.g1_lincomb_naive(commitments, r_powers), gc.g1_lincomb_naive(proofs, r_times_z))
    assert want == [lhs_gold, gc.g1_sub(rhs_gold, gc.g1_mul(gc.G1_GENERATOR, ry))]


def test_sharded_flags_and_combine():
    """A point off the subgroup in the last shard clears flag 1 of the
    combined flags, as it does unsharded."""
    _, _, comp, _, _, _ = _batch_points(4)
    comp = comp.copy()
    x = 0
    while True:  # a curve point outside the subgroup: y^2 = x^3 + 4
        x += 1
        y = fp_sqrt((x**3 + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            break
    comp[7] = np.frombuffer(gc.g1_compress((x, y)), dtype=np.uint8)
    comp_t = torch.from_numpy(comp)
    assert S.sharded_batch_points(comp_t, cpu_mesh(2))[2].tolist() == V.batch_points(comp_t)[2].tolist() == [1, 0]


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_bary_blobs(d):
    """The batch's barycentric evaluation with 4 minimal blobs (one of them
    padding) split over d shards: the unsharded ys and flag, the JAX
    blob-split kernel's ys (its public-API test's shapes); a non-canonical
    element clears the flag."""
    settings, jsettings = make_insecure_setup(MINIMAL), j_make_insecure_setup(J_MINIMAL)
    blobs = np.frombuffer(b"".join(_blob(4) for _ in range(3)), dtype=np.uint8).reshape(3, 4, 32).copy()
    xs = [rng.randrange(R) for _ in range(3)] + [0]
    xs_t = torch.from_numpy(L.ints_to_words(L.FR.nwords, xs))
    ctxs = [PK.FrContext.build(settings, "cpu")] * d
    ys, ok = S.sharded_bary_blobs(ctxs, torch.from_numpy(blobs), xs_t, cpu_mesh(d))
    padded = torch.from_numpy(np.concatenate([blobs, np.zeros((1, 4, 32), np.uint8)]))
    want, want_ok = V.bary_batch_from_bytes(ctxs[0], padded, xs_t)
    assert bool(ok) and bool(want_ok)
    assert L.words_to_ints(ys) == L.words_to_ints(want)
    jctx = JaxBackend()._fr_ctx(jsettings)
    jys, jok = JS.sharded_bary_blobs_kernel(
        jctx.n, jctx.roots_m, jctx.roots_m2, jctx.inv_n_m, jnp.asarray(padded.numpy()), jnp.asarray(JL.ints_to_limbs(JFR.nlimbs, xs)), JS.blobs_mesh(4)
    )
    assert bool(np.asarray(jok)) and L.words_to_ints(ys) == JL.limbs_to_ints(np.asarray(jys))
    blobs[2, 1] = 0xFF
    assert not bool(S.sharded_bary_blobs(ctxs, torch.from_numpy(blobs), xs_t, cpu_mesh(d))[1])


def test_shard_rows_pads_and_checks():
    t = torch.arange(6).reshape(3, 2)
    parts = S.shard_rows(t, cpu_mesh(2), 4)
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [0, 0]]]
    with pytest.raises(ValueError, match="not divisible"):
        S.shard_rows(t, cpu_mesh(2))


# ---------------------------------------------------------------------------
# The public API through the backend's mesh method
# ---------------------------------------------------------------------------


def _patched_mesh(monkeypatch, backend, d: int):
    """The backend's mesh method gives ``cpu_mesh(d)`` wherever d divides n,
    as ``_auto_mesh`` does with d cards."""
    monkeypatch.setattr(backend, "_auto_mesh", lambda n, kind: cpu_mesh(d) if n % d == 0 else None)


def _counting(monkeypatch, names) -> dict:
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(S, name)

        def wrapper(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(S, name, wrapper)
    return calls


def test_public_api_batch_hits_sharded_kernels(monkeypatch):
    """A public-API batch on a 2-shard blob mesh goes through the three
    sharded stages once each and gives the golden backend's verdict; a
    swapped proof goes the same way to False."""
    settings = make_insecure_setup(MINIMAL)
    golden = GoldenBackend()
    blobs = [Blob(_blob(4), bytes_per_blob=MINIMAL.bytes_per_blob) for _ in range(4)]
    cs = [Kzg.blob_to_kzg_commitment(b, settings, golden) for b in blobs]
    ps = [Kzg.compute_blob_kzg_proof(b, c, settings, golden) for b, c in zip(blobs, cs)]
    calls = _counting(monkeypatch, ["sharded_batch_points", "sharded_bary_blobs", "sharded_batch_stage2"])
    backend = TorchBackend(device="cpu")
    _patched_mesh(monkeypatch, backend, 2)
    assert Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, backend) is True
    assert calls == {"sharded_batch_points": 1, "sharded_bary_blobs": 1, "sharded_batch_stage2": 1}
    swapped = [ps[1], ps[0]] + ps[2:]
    assert Kzg.verify_blob_kzg_proof_batch(blobs, cs, swapped, settings, backend) is False
    assert calls["sharded_batch_stage2"] == 2


def test_public_api_prover_hits_sharded_paths(monkeypatch, t16, jax_t16):
    """On a 2-shard mesh the public-API commit takes the point-split commit,
    and ``compute_kzg_proof`` the protocol's piecewise path through the
    domain-split evaluation and the point-split MSM: the JAX backend's
    bytes on its 8 devices, and the golden backend's."""
    settings, _, ctxs = t16
    monkeypatch.setenv("KZG_TORCH_PROVER", "device")
    calls = _counting(monkeypatch, ["sharded_commit", "sharded_bary", "msm_fixed_base_sharded"])
    backend = TorchBackend(device="cpu")
    _patched_mesh(monkeypatch, backend, 2)
    settings._device_cache[("msm", "cpu", "cpu")] = ctxs[2]  # built by the fixture
    golden = GoldenBackend()
    blob = Blob(jax_t16["blob"], bytes_per_blob=T16.bytes_per_blob)
    c = Kzg.blob_to_kzg_commitment(blob, settings, backend)
    assert bytes(c) == jax_t16["commitment"] == bytes(Kzg.blob_to_kzg_commitment(blob, settings, golden))
    assert calls["sharded_commit"] == 1
    z = Bytes32((7).to_bytes(32, "big"))
    got = [bytes(x) for x in Kzg.compute_kzg_proof(blob, z, settings, backend)]
    assert tuple(got) == jax_t16["proof"]
    assert got == [bytes(x) for x in Kzg.compute_kzg_proof(blob, z, settings, golden)]
    assert calls["sharded_bary"] >= 1 and calls["msm_fixed_base_sharded"] == 1


# ---------------------------------------------------------------------------
# distributed.py: ranks joined by torch.distributed
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world_inputs():
    """8 blobs and 16 points with an infinity point and a zero scalar (the
    shapes of tests/test_parallel_distributed.py), and the JAX 2 x 4
    (host, chip) mesh's flags, stage-2 points and MSM."""
    commitments, proofs, comp, r_powers, r_times_z, ry = _batch_points(8)
    digits = V.stage2_digits(8, r_powers, r_times_z)
    sy = M.recode_signed_digits([ry], 1)
    points = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(16)]
    points[3] = None
    scalars = [rng.randrange(R) for _ in range(16)]
    scalars[5] = 0
    mesh = JD.host_chip_mesh(2, 4)
    jb1, jb2, jflags = JD.batch_points_kernel_2axis(jnp.asarray(comp), mesh)
    jout = JD.batch_stage2_kernel_2axis(jb1, jb2, jnp.asarray(digits), JV.build_generator_table(), jnp.asarray(sy, dtype=jnp.int32), mesh)
    jmsm = JD.msm_fixed_base_2axis(JD.ShardedMsmContext2Axis.build_from_points(points, mesh, fold=16), scalars)
    return {
        "comp": comp,
        "digits": digits,
        "sy": sy,
        "points": points,
        "scalars": scalars,
        "want": {"flags": np.asarray(jflags).tolist(), "stage2": [str(p) for p in JC.proj_to_points(np.asarray(jout))], "msm": str(jmsm)},
    }


# A rank's work, run by the in-process world of one and by each process of
# the two-process world (which imports neither JAX nor this module).
_WORLD = """
import numpy as np
import torch

from kzg_rust_tpu_torch.ops import curve as C
from kzg_rust_tpu_torch.ops import verify_kernels as V
from kzg_rust_tpu_torch.parallel import distributed as D


def world_results(comp, digits, sy, points, scalars, devices):
    mesh = D.host_chip_mesh(devices)
    bases, bases2, flags = D.batch_points_2axis(torch.from_numpy(comp.copy()), mesh)
    gen = V.build_generator_table(mesh.devices[0])
    out = D.batch_stage2_2axis(bases, bases2, torch.from_numpy(digits), gen, torch.from_numpy(sy), mesh)
    ctx = D.ShardedMsmContext2Axis.build_from_points(points, mesh)
    msm = D.msm_fixed_base_2axis(ctx, scalars)
    return {"flags": flags.tolist(), "stage2": [str(p) for p in C.proj_to_points(out)], "msm": str(msm)}
"""


def test_initialize_distributed_reaches_torch():
    """No coordinator listens: the call reaches torch.distributed and fails
    there, within its timeout, instead of doing nothing."""
    with pytest.raises(Exception):
        D.initialize_distributed(f"tcp://localhost:{_free_port()}", world_size=2, rank=1, backend="gloo", timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()


def test_world_of_one_matches_jax_2x4(world_inputs):
    """A gloo world of one rank over 2 local CPU devices: the 2-axis stages
    and MSM give the JAX 2 x 4 mesh's flags and points."""
    import torch.distributed as dist

    rank = {}
    exec(_WORLD, rank)
    D.initialize_distributed(f"tcp://localhost:{_free_port()}", world_size=1, rank=0, backend="gloo", timeout=datetime.timedelta(seconds=30))
    try:
        mesh = D.host_chip_mesh(cpu_mesh(2))
        assert (mesh.rank, mesh.world, mesh.devices) == (0, 1, cpu_mesh(2))
        w = world_inputs
        got = rank["world_results"](w["comp"], w["digits"], w["sy"], w["points"], w["scalars"], cpu_mesh(2))
    finally:
        dist.destroy_process_group()
    assert got == w["want"]
    assert w["want"]["flags"] == [1, 1]
    assert w["want"]["msm"] == str(gc.g1_lincomb_naive(w["points"], w["scalars"]))


_CHILD = """
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
{world}
torch.set_num_threads(1)
D.initialize_distributed(sys.argv[2], world_size=2, rank=int(sys.argv[3]), backend="gloo", timeout=datetime.timedelta(seconds=40))
inp = json.loads(open(sys.argv[4]).read())
args = [np.array(inp[k], dtype=np.uint8 if k == "comp" else np.int8) for k in ("comp", "digits", "sy")]
points = [None if p is None else tuple(p) for p in inp["points"]]
print(json.dumps(world_results(*args, points, inp["scalars"], [torch.device("cpu")] * 2)))
torch.distributed.destroy_process_group()
"""


def test_two_process_gloo_world(world_inputs, tmp_path):
    """Two processes, a rank each over 2 local CPU devices, joined by
    ``initialize_distributed`` over gloo: every rank's 2-axis stages and
    MSM give the JAX 2 x 4 mesh's flags and points."""
    w = world_inputs
    payload = tmp_path / "inputs.json"
    payload.write_text(
        json.dumps({"comp": w["comp"].tolist(), "digits": w["digits"].tolist(), "sy": w["sy"].tolist(), "points": w["points"], "scalars": w["scalars"]})
    )
    code = _CHILD.format(world=_WORLD)
    address = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(REPO_ROOT), address, str(rank), str(payload)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert outs == [w["want"], w["want"]]
