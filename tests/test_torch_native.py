"""The native host engine under the port.

``kzg_rust_tpu_torch.native`` against the JAX package's
``kzg_rust_tpu.native`` and the golden model on the same seeded inputs: the
G1 and G2 codecs with invalid encodings, the multiplies, the lincomb, the
pairing, SHA-256, ``BaryCtx`` and the fused ``VerifyCtx`` and ``ProverCtx``.
Then explicit host placement: ``TorchBackend(device="cpu")`` with
``KZG_TORCH_EVAL=host`` and ``KZG_TORCH_PROVER=host`` against ``JaxBackend``
with ``KZG_TPU_EVAL=host`` and ``KZG_TPU_PROVER=host`` on the minimal
vectors and a 16-point prover, with the same bytes and error classes; the
placement errors; where the library is built; the preset modules; and the
engine's threads beside the port's hash pool.  Skipped as a module where
either package's engine does not load.
"""

from __future__ import annotations

import glob
import hashlib
import os
import pathlib
import random
import sys
import threading

import pytest
import yaml

from kzg_rust_tpu import Kzg as JKzg
from kzg_rust_tpu import native as jnat
from kzg_rust_tpu.backends.jax_backend import JaxBackend
from kzg_rust_tpu.errors import KzgError as JKzgError
from kzg_rust_tpu.presets import MINIMAL as J_MINIMAL
from kzg_rust_tpu.presets import Preset as JPreset
from kzg_rust_tpu.types import Blob as JBlob
from kzg_rust_tpu.types import Bytes32 as JBytes32
from kzg_rust_tpu.types import Bytes48 as JBytes48
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch import Blob, Bytes32, Bytes48, Kzg, KzgError, hostcrypto, kzg_mainnet, kzg_minimal
from kzg_rust_tpu_torch import native as nat
from kzg_rust_tpu_torch.backends import torch_backend as TB
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend
from kzg_rust_tpu_torch.errors import BadArgs, InvalidBytesLength, InvalidTrustedSetup
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden import field as gf
from kzg_rust_tpu_torch.golden import pairing as gp
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.presets import (
    FIAT_SHAMIR_PROTOCOL_DOMAIN,
    MAINNET,
    MINIMAL,
    RANDOM_CHALLENGE_KZG_BATCH_DOMAIN,
    Preset,
)
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup, write_insecure_setup_file

from .conftest import REPO_ROOT

rng = random.Random(0x7A7E)
N16 = 16
T16 = Preset(name="t16", field_elements_per_blob=N16)
PLACEMENT_VARS = ("KZG_TORCH_EVAL", "KZG_TORCH_PROVER")


@pytest.fixture(autouse=True, scope="module")
def _engines():
    """Builds (or finds) both packages' engines once; skips the module where
    either does not load."""
    if not (nat.available() and jnat.available()):
        pytest.skip(f"native host engine not available: {nat.BUILD_INFO.get('error')}")


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    for var in PLACEMENT_VARS:
        monkeypatch.delenv(var, raising=False)


def rand_g1():
    return gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, gc.R))


def rand_g2():
    return gc.g2_mul(gc.G2_GENERATOR, rng.randrange(1, gc.R))


def outcome(fn):
    """``fn()``'s value, or its error's class name and message."""
    try:
        return fn()
    except (KzgError, JKzgError) as e:
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# The engine's wrappers against the JAX package's and the golden model
# ---------------------------------------------------------------------------


def test_g1_codec_and_arithmetic():
    for _ in range(8):
        p, q = rand_g1(), rand_g1()
        comp = gc.g1_compress(p)
        assert nat.g1_compress(p) == jnat.g1_compress(p) == comp
        assert nat.g1_uncompress(comp) == jnat.g1_uncompress(comp) == p
        assert nat.g1_add(p, q) == jnat.g1_add(p, q) == gc.g1_add(p, q)
        assert nat.g1_sub(p, q) == jnat.g1_sub(p, q) == gc.g1_sub(p, q)
        k = rng.randrange(gc.R)
        assert nat.g1_mul(p, k) == jnat.g1_mul(p, k) == gc.g1_mul(p, k)
        assert nat.g1_in_subgroup(p) is True
    p = rand_g1()
    assert nat.g1_add(p, p) == gc.g1_add(p, p)
    assert nat.g1_add(p, gc.g1_neg(p)) is None
    assert nat.g1_add(None, p) == nat.g1_add(p, None) == p
    assert nat.g1_mul(p, 0) is None and nat.g1_mul(None, 5) is None
    assert nat.g1_mul(p, gc.R + 3) == gc.g1_mul(p, 3)
    assert nat.g1_compress(None) == gc.g1_compress(None)
    assert nat.g1_uncompress(gc.g1_compress(None)) is None
    pts = [rand_g1(), None, rand_g1()]
    assert nat.g1_uncompress_batch([gc.g1_compress(x) for x in pts]) == pts
    assert nat.g1_uncompress_batch([]) == []


def _off_subgroup_point():
    x = 3
    while True:
        y = gf.fp_sqrt((x * x * x + 4) % gf.P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


def test_g1_subgroup():
    off = _off_subgroup_point()
    assert nat.g1_in_subgroup(off) is jnat.g1_in_subgroup(off) is False
    assert nat.g1_in_subgroup(None) is True
    assert nat.g1_subgroup_batch([rand_g1(), None, gc.G1_GENERATOR]) is True
    assert nat.g1_subgroup_batch([rand_g1(), off]) is False
    assert nat.g1_subgroup_batch([]) is True


G1_INVALID = [
    b"\x00" * 48,  # compressed bit unset
    b"\xc0" + b"\x01" + b"\x00" * 46,  # bad infinity encoding
    b"\xff" * 48,  # flags + x out of range
    bytes([0x9F]) + b"\xff" * 47,  # x >= p
    bytes([0x80]) + b"\x00" * 47,  # x = 0: y^2 = 4 is a residue, a valid point
    b"\x11" * 48,  # the malformed lane of chip_smoke.py
]


@pytest.mark.parametrize("data", G1_INVALID, ids=lambda d: d[:2].hex())
def test_g1_uncompress_encodings_match_golden(data):
    want = outcome(lambda: gc.g1_uncompress(data))
    got = outcome(lambda: nat.g1_uncompress(data))
    assert got == outcome(lambda: jnat.g1_uncompress(data))
    if isinstance(want, tuple) and want[0] == "BadArgs":  # the engine has one message for all
        assert got == ("BadArgs", "g1_uncompress: malformed point encoding")
        with pytest.raises(BadArgs):
            nat.g1_uncompress_batch([gc.g1_compress(rand_g1()), data])
    else:
        assert got == want
    with pytest.raises(BadArgs):
        nat.g1_uncompress(data[:47])


G2_INVALID = [
    b"\x00" * 96,  # compressed bit unset
    b"\xc0" + b"\x01" + b"\x00" * 94,  # bad infinity encoding
    b"\xe0" + b"\x00" * 95,  # infinity with the sign bit set
    b"\x9f" + b"\xff" * 95,  # x out of range
    b"\x80" + b"\x00" * 95,  # x = 0
    b"\x80" + b"\x00" * 46 + b"\x01" + b"\x00" * 48,  # an x off the curve
    b"\x12" * 96,
    b"\x00" * 95,  # wrong length
]


@pytest.mark.parametrize("data", G2_INVALID, ids=lambda d: f"{d[:2].hex()}-{len(d)}")
def test_g2_uncompress_encodings_match_golden(data):
    got = outcome(lambda: nat.g2_uncompress(data))
    assert got == outcome(lambda: gc.g2_uncompress(data)) == outcome(lambda: jnat.g2_uncompress(data))


def test_g2_codec_and_arithmetic():
    for _ in range(3):
        q, q2 = rand_g2(), rand_g2()
        comp = gc.g2_compress(q)
        assert nat.g2_uncompress(comp) == jnat.g2_uncompress(comp) == q
        k = rng.randrange(gc.R)
        assert nat.g2_mul(q, k) == jnat.g2_mul(q, k) == gc.g2_mul(q, k)
        assert nat.g2_add(q, q2) == gc.g2_add(q, q2)
        assert nat.g2_sub(q, q2) == gc.g2_sub(q, q2)
    assert nat.g2_uncompress(gc.g2_compress(None)) is None
    assert nat.g2_mul(rand_g2(), 0) is None


@pytest.mark.parametrize("n", [0, 1, 7, 16])
def test_g1_lincomb(n):
    edge = [0, 1, gc.R - 1, 1 << 254, (gc.R - 1) >> 1]
    pts = [rand_g1() for _ in range(n)]
    scs = [rng.randrange(gc.R) for _ in range(n)]
    for j in range(min(n, len(edge))):
        scs[j] = edge[j]
    if n > 2:
        pts[n // 2] = None
    assert nat.g1_lincomb_naive(pts, scs) == jnat.g1_lincomb_naive(pts, scs) == gc.g1_lincomb_naive(pts, scs)
    with pytest.raises(ValueError):
        nat.g1_lincomb_naive(pts, scs + [1])


def test_pairing_true_false_and_infinity():
    a, b = rng.randrange(1, gc.R), rng.randrange(1, gc.R)
    aP = gc.g1_mul(gc.G1_GENERATOR, a)
    bQ = gc.g2_mul(gc.G2_GENERATOR, b)
    abP = gc.g1_mul(gc.G1_GENERATOR, a * b % gc.R)
    cases = [
        ((abP, gc.G2_GENERATOR, aP, bQ), True),
        ((aP, gc.G2_GENERATOR, aP, bQ), False),
        ((None, gc.G2_GENERATOR, None, gc.G2_GENERATOR), True),
        ((aP, gc.G2_GENERATOR, None, gc.G2_GENERATOR), False),
        ((aP, None, aP, gc.G2_GENERATOR), False),
        ((None, None, None, None), True),
    ]
    for args, want in cases:
        assert nat.pairings_verify(*args) is jnat.pairings_verify(*args) is gp.pairings_verify(*args) is want


@pytest.mark.parametrize("size", [0, 1, 55, 56, 63, 64, 65, 127, 128, 1000, 131232])
def test_sha256(size):
    data = bytes(rng.randrange(256) for _ in range(min(size, 256))) * ((size + 255) // 256)
    data = data[:size]
    assert nat.sha256(data) == jnat.sha256(data) == hashlib.sha256(data).digest()


def _blobs(n_elems: int, count: int) -> list[bytes]:
    return [b"".join(rng.randrange(gf.R).to_bytes(32, "big") for _ in range(n_elems)) for _ in range(count)]


def _evals(blob: bytes) -> list[int]:
    return [int.from_bytes(blob[i : i + 32], "big") for i in range(0, len(blob), 32)]


@pytest.mark.parametrize("preset", [MINIMAL, T16], ids=["minimal", "t16"])
def test_bary_ctx(preset):
    settings = make_insecure_setup(preset)
    n = preset.field_elements_per_blob
    blobs = _blobs(n, 4)
    xs = [rng.randrange(1, gf.R) for _ in blobs]
    ctx = hostcrypto.bary_ctx(settings.roots_of_unity)
    ys = ctx.eval_batch(b"".join(blobs), len(blobs), xs)
    assert ys == jnat.BaryCtx(settings.roots_of_unity).eval_batch(b"".join(blobs), len(blobs), xs)
    golden = GoldenBackend()
    assert ys == [golden.barycentric_eval(settings, _evals(b), x) for b, x in zip(blobs, xs)]
    if preset is T16:  # the card's evaluation, as its plain version runs it
        assert ys[0] == TorchBackend(device="cpu").barycentric_eval(settings, _evals(blobs[0]), xs[0])
    with pytest.raises(BadArgs):
        ctx.eval_batch(b"\xff" * 32 + b"".join(blobs)[32:], len(blobs), xs)
    with pytest.raises(ValueError):
        ctx.eval_batch(b"".join(blobs)[:-1], len(blobs), xs)


# ---------------------------------------------------------------------------
# The fused contexts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def minimal_batch():
    """Three minimal-preset blobs with golden commitments and proofs, in
    both packages' setups (the same tau)."""
    settings, jsettings = make_insecure_setup(MINIMAL), j_make_insecure_setup(J_MINIMAL)
    golden = GoldenBackend()
    blobs, comms, proofs = [], [], []
    for _ in range(3):
        blob = Blob(b"".join(b"\x00" + rng.randbytes(31) for _ in range(MINIMAL.field_elements_per_blob)), bytes_per_blob=MINIMAL.bytes_per_blob)
        c = Kzg.blob_to_kzg_commitment(blob, settings, golden)
        blobs.append(blob)
        comms.append(bytes(c))
        proofs.append(bytes(Kzg.compute_blob_kzg_proof(blob, c, settings, golden)))
    return settings, jsettings, blobs, comms, proofs


def _verify_ctxs(settings, jsettings):
    port = TorchBackend(device="cpu")._verify_native_ctx(settings)
    jax = jnat.VerifyCtx(
        jsettings.roots_of_unity, jsettings.g2_values[1], gc.G2_GENERATOR, FIAT_SHAMIR_PROTOCOL_DOMAIN, RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
    )
    return port, jax


def test_verify_ctx_lanes(minimal_batch):
    """The tampered and malformed lanes: both engines give the same outcome,
    the golden backend the same value or error class."""
    settings, jsettings, blobs, comms, proofs = minimal_batch
    port, jax = _verify_ctxs(settings, jsettings)
    joined = b"".join(bytes(b) for b in blobs)
    nonsub = gc.g1_compress(_off_subgroup_point())
    lanes = {
        "valid": (joined, comms, proofs, True),
        "swapped_proof": (joined, comms, [proofs[1], proofs[0], proofs[2]], False),
        "malformed_commitment": (joined, [b"\x12" * 48] + comms[1:], proofs, None),
        "malformed_proof": (joined, comms, proofs[:2] + [b"\x11" * 48], None),
        "non_subgroup": (joined, [nonsub] + comms[1:], proofs, None),
        "noncanonical_blob": (b"\xff" * 32 + joined[32:], comms, proofs, None),
    }
    golden = GoldenBackend()
    n = MINIMAL.bytes_per_blob
    for lane, (blob_bytes, cs, ps, want) in lanes.items():
        c, p = b"".join(cs), b"".join(ps)
        got = outcome(lambda: port.verify(blob_bytes, 3, c, p))
        assert got == outcome(lambda: jax.verify(blob_bytes, 3, c, p)), lane
        scattered = [blob_bytes[i : i + n] for i in range(0, len(blob_bytes), n)]
        assert outcome(lambda: port.verify_scatter(scattered, 3, c, p)) == got, lane
        gold = outcome(
            lambda: Kzg.verify_blob_kzg_proof_batch(
                [Blob(b, bytes_per_blob=n) for b in scattered], [Bytes48(x) for x in cs], [Bytes48(x) for x in ps], settings, golden
            )
        )
        if want is None:
            assert isinstance(got, tuple) and got[0] == gold[0] == "BadArgs", lane
        else:
            assert got is gold is want, lane
    with pytest.raises(ValueError):
        port.verify(joined, 3, b"".join(comms[:2]), b"".join(proofs))


def test_verify_ctx_single_calls(minimal_batch):
    settings, jsettings, blobs, comms, proofs = minimal_batch
    port, jax = _verify_ctxs(settings, jsettings)
    golden = GoldenBackend()
    z = Bytes32((7).to_bytes(32, "big"))
    proof, y = Kzg.compute_kzg_proof(blobs[0], z, settings, golden)
    bad_y = (int.from_bytes(bytes(y), "big") ^ 1).to_bytes(32, "big")
    for yy, want in ((bytes(y), True), (bad_y, False)):
        args = (comms[0], bytes(z), yy, bytes(proof))
        assert port.verify_single(*args) is jax.verify_single(*args) is want
    assert outcome(lambda: port.verify_single(b"\x12" * 48, bytes(z), bytes(y), bytes(proof)))[0] == "BadArgs"
    for i, want in ((0, True), (1, False)):
        args = (bytes(blobs[i]), comms[i], proofs[0])
        assert port.verify_blob_single(*args) is jax.verify_blob_single(*args) is want
        assert Kzg.verify_blob_kzg_proof(blobs[i], Bytes48(comms[i]), Bytes48(proofs[0]), settings, golden) is want


@pytest.fixture(scope="module")
def t16():
    settings, jsettings = make_insecure_setup(T16), j_make_insecure_setup(JPreset(name="t16", field_elements_per_blob=N16))
    blobs = _blobs(N16, 2) + [bytes(32 * N16), (gf.R - 1).to_bytes(32, "big") * N16]
    return settings, jsettings, blobs


def test_prover_ctx_t16(t16):
    settings, jsettings, blobs = t16
    port = TorchBackend(device="cpu")._prover_native_ctx(settings)
    jax = jnat.ProverCtx(jsettings.roots_of_unity, jsettings.g1_values, FIAT_SHAMIR_PROTOCOL_DOMAIN)
    golden = GoldenBackend()
    for blob in blobs:
        c = port.commit(blob)
        assert c == jax.commit(blob)
        assert gc.g1_compress(c) == bytes(Kzg.blob_to_kzg_commitment(Blob(blob, bytes_per_blob=T16.bytes_per_blob), settings, golden))
    blob = Blob(blobs[0], bytes_per_blob=T16.bytes_per_blob)
    for z in (rng.randrange(gf.R), settings.roots_of_unity[0], settings.roots_of_unity[5]):
        z32 = z.to_bytes(32, "big")
        got = port.prove(bytes(blob), z32)
        assert got == jax.prove(bytes(blob), z32)
        proof, y = Kzg.compute_kzg_proof(blob, Bytes32(z32), settings, golden)
        assert (gc.g1_compress(got[0]), got[1].to_bytes(32, "big")) == (bytes(proof), bytes(y))
    comm = gc.g1_compress(port.commit(bytes(blob)))
    assert port.blob_proof(bytes(blob), comm) == jax.blob_proof(bytes(blob), comm)
    assert gc.g1_compress(port.blob_proof(bytes(blob), comm)) == bytes(Kzg.compute_blob_kzg_proof(blob, Bytes48(comm), settings, golden))
    bad = b"\xff" * 32 + bytes(blob)[32:]
    for call in (lambda c: c.commit(bad), lambda c: c.prove(bad, bytes(32)), lambda c: c.blob_proof(bytes(blob), b"\x12" * 48)):
        got = outcome(lambda: call(port))
        assert got[0] == "BadArgs" and got == outcome(lambda: call(jax))


# ---------------------------------------------------------------------------
# Host placement through the backends
# ---------------------------------------------------------------------------


def _minimal_vectors():
    files = sorted(glob.glob(str(REPO_ROOT / "tests" / "vectors_minimal" / "*" / "*" / "*" / "data.yaml")))
    return [pytest.param(f, id="/".join(f.rsplit("/", 4)[-4:-1:2])) for f in files]


@pytest.fixture(scope="module")
def minimal_file_settings():
    path = REPO_ROOT / "data" / "trusted_setup_minimal.txt"
    return Kzg.load_trusted_setup_file(path, MINIMAL), JKzg.load_trusted_setup_file(path, J_MINIMAL)


def _run_vector(api, types, suite, inp, settings, backend):
    blob_t, b32, b48 = types
    blob = lambda h: blob_t.from_hex(h, bytes_per_blob=MINIMAL.bytes_per_blob)  # noqa: E731
    hexed = lambda x: "0x" + bytes(x).hex()  # noqa: E731
    if suite == "blob_to_kzg_commitment":
        return hexed(api.blob_to_kzg_commitment(blob(inp["blob"]), settings, backend))
    if suite == "compute_kzg_proof":
        return [hexed(x) for x in api.compute_kzg_proof(blob(inp["blob"]), b32.from_hex(inp["z"]), settings, backend)]
    if suite == "compute_blob_kzg_proof":
        return hexed(api.compute_blob_kzg_proof(blob(inp["blob"]), b48.from_hex(inp["commitment"]), settings, backend))
    if suite == "verify_kzg_proof":
        args = (b48.from_hex(inp["commitment"]), b32.from_hex(inp["z"]), b32.from_hex(inp["y"]), b48.from_hex(inp["proof"]))
        return api.verify_kzg_proof(*args, settings, backend)
    if suite == "verify_blob_kzg_proof":
        return api.verify_blob_kzg_proof(blob(inp["blob"]), b48.from_hex(inp["commitment"]), b48.from_hex(inp["proof"]), settings, backend)
    return api.verify_blob_kzg_proof_batch(
        [blob(h) for h in inp["blobs"]], [b48.from_hex(h) for h in inp["commitments"]], [b48.from_hex(h) for h in inp["proofs"]], settings, backend
    )


@pytest.fixture
def host_placement(monkeypatch):
    """Both packages on their host engines; the port's device paths raise,
    so a pass shows that no call reached them."""
    for var in ("KZG_TORCH_EVAL", "KZG_TORCH_PROVER", "KZG_TPU_EVAL", "KZG_TPU_PROVER"):
        monkeypatch.setenv(var, "host")

    def device(*_a, **_k):
        raise AssertionError("host placement reached a device path")

    for name in ("_verify_batch_device", "_msm_ctx", "barycentric_eval", "quotient_out_of_domain", "quotient_in_domain"):
        monkeypatch.setattr(TorchBackend, name, device)


@pytest.mark.parametrize("path", _minimal_vectors())
def test_host_placement_minimal_vectors(path, minimal_file_settings, host_placement):
    settings, jsettings = minimal_file_settings
    with open(path) as fh:
        case = yaml.safe_load(fh)
    suite = pathlib.Path(path).parts[-4]
    got = outcome(lambda: _run_vector(Kzg, (Blob, Bytes32, Bytes48), suite, case["input"], settings, TorchBackend(device="cpu")))
    want = outcome(lambda: _run_vector(JKzg, (JBlob, JBytes32, JBytes48), suite, case["input"], jsettings, JaxBackend()))
    assert got == want
    assert (None if isinstance(got, tuple) else got) == case["output"]


def test_host_placement_t16_prover(t16, host_placement):
    settings, jsettings, blobs = t16
    port, jax = TorchBackend(device="cpu"), JaxBackend()
    for raw in blobs:
        blob, jblob = Blob(raw, bytes_per_blob=T16.bytes_per_blob), JBlob(raw, bytes_per_blob=T16.bytes_per_blob)
        c = Kzg.blob_to_kzg_commitment(blob, settings, port)
        assert bytes(c) == bytes(JKzg.blob_to_kzg_commitment(jblob, jsettings, jax))
        for z in (rng.randrange(gf.R), settings.roots_of_unity[3]):
            z32 = z.to_bytes(32, "big")
            got = Kzg.compute_kzg_proof(blob, Bytes32(z32), settings, port)
            want = JKzg.compute_kzg_proof(jblob, JBytes32(z32), jsettings, jax)
            assert [bytes(x) for x in got] == [bytes(x) for x in want]
            assert Kzg.verify_kzg_proof(c, Bytes32(z32), got[1], got[0], settings, port) is True
        bp = Kzg.compute_blob_kzg_proof(blob, c, settings, port)
        assert bytes(bp) == bytes(JKzg.compute_blob_kzg_proof(jblob, JBytes48(bytes(c)), jsettings, jax))
        assert Kzg.verify_blob_kzg_proof(blob, c, bp, settings, port) is True
    short = Blob(blobs[0][:-32], bytes_per_blob=T16.bytes_per_blob - 32)
    for call in (
        lambda be, s: be.blob_to_commitment_pipeline(s, short),
        lambda be, s: be.compute_kzg_proof_pipeline(s, short, 5),
        lambda be, s: be.compute_blob_proof_pipeline(s, short, bytes(48)),
        lambda be, s: be.compute_blob_proof_pipeline(s, blobs[0], bytes(47)),
    ):
        got, want = outcome(lambda: call(port, settings)), outcome(lambda: call(jax, jsettings))
        assert got[0] == "BadArgs" and got == want


def _batch_lanes(blobs, comms, proofs):
    """The minimal batch and its bad lanes, as the API takes them."""
    bad_blob = Blob(b"\xff" * 32 + bytes(blobs[0])[32:], bytes_per_blob=MINIMAL.bytes_per_blob)
    return {
        "valid": (blobs, comms, proofs),
        "swapped_proof": (blobs, comms, [proofs[1], proofs[0], proofs[2]]),
        "malformed_commitment": (blobs, [b"\x12" * 48] + comms[1:], proofs),
        "non_subgroup": (blobs, [gc.g1_compress(_off_subgroup_point())] + comms[1:], proofs),
        "noncanonical_blob": ([bad_blob] + blobs[1:], comms, proofs),
    }


@pytest.mark.parametrize("mode", ["auto", "host-piecewise", "tpu"])
@pytest.mark.parametrize("var", PLACEMENT_VARS)
def test_placement_refuses_unported_modes(var, mode, monkeypatch, minimal_batch):
    """``auto`` resolves on each variable: on a CPU backend it is the
    engine, whose answer the JAX backend's host placement gives too.
    ``host-piecewise`` is the JAX backend's: a batch in the engine's
    separate calls, with the JAX backend's ``host-piecewise`` outcome (value,
    or error class and message) on the valid batch and each bad lane, and
    host placement's value or error class; on the prover it is the device
    path, whose fused call declines as the JAX backend's does.  Unknown
    values raise."""
    settings, jsettings, blobs, comms, proofs = minimal_batch
    monkeypatch.setenv(var, mode)
    backend = TorchBackend(device="cpu")
    call = {
        "KZG_TORCH_EVAL": lambda: backend.verify_blob_batch_pipeline(settings, blobs, comms, proofs),
        "KZG_TORCH_PROVER": lambda: backend.compute_blob_proof_pipeline(settings, blobs[0], comms[0]),
    }[var]
    if mode == "tpu":
        with pytest.raises(ValueError, match="expected one of device, host, auto, host-piecewise"):
            call()
        return
    if mode == "host-piecewise":
        monkeypatch.setenv(var.replace("TORCH", "TPU"), mode)
        jax = JaxBackend()
        if var == "KZG_TORCH_PROVER":
            assert call() is NotImplemented
            assert jax.compute_blob_proof_pipeline(jsettings, blobs[0], comms[0]) is NotImplemented
            assert backend._prover_mode(settings) == "device"
            return
        monkeypatch.setattr(backend, "_verify_batch_device", lambda *a: pytest.fail("host-piecewise reached the device path"))
        for lane, (bs, cs, ps) in _batch_lanes(blobs, comms, proofs).items():
            monkeypatch.setenv(var, mode)
            got = outcome(lambda: backend.verify_blob_batch_pipeline(settings, bs, cs, ps))
            assert got == outcome(lambda: jax.verify_blob_batch_pipeline(jsettings, bs, cs, ps)), lane
            monkeypatch.setenv(var, "host")
            host = outcome(lambda: backend.verify_blob_batch_pipeline(settings, bs, cs, ps))
            assert (got[0] if isinstance(got, tuple) else got) == (host[0] if isinstance(host, tuple) else host), lane
            assert got == {"valid": True, "swapped_proof": False}.get(lane, got) and (lane in ("valid", "swapped_proof") or got[0] == "BadArgs"), lane
        monkeypatch.setattr(TB.hostcrypto, "bary_ctx", lambda roots: None)
        monkeypatch.setenv(var, mode)
        with pytest.raises(RuntimeError, match="host-piecewise but the native host engine is not available"):
            TorchBackend(device="cpu").verify_blob_batch_pipeline(make_insecure_setup(MINIMAL), blobs, comms, proofs)
        return
    for name in ("_verify_batch_device", "_msm_ctx"):
        monkeypatch.setattr(backend, name, lambda *a: pytest.fail("auto on a CPU backend reached the device path"))
    monkeypatch.setenv(var.replace("TORCH", "TPU"), "host")
    jax = {
        "KZG_TORCH_EVAL": lambda: JaxBackend().verify_blob_batch_pipeline(jsettings, blobs, comms, proofs),
        "KZG_TORCH_PROVER": lambda: JaxBackend().compute_blob_proof_pipeline(jsettings, blobs[0], comms[0]),
    }[var]
    assert call() == jax()
    assert call() == (True if var == "KZG_TORCH_EVAL" else gc.g1_uncompress(proofs[0]))


def test_device_placement_is_the_default(minimal_batch):
    """Unset, both variables mean the card: the fused single calls decline
    and the protocol's device path runs."""
    _, _, blobs, comms, proofs = minimal_batch
    settings = make_insecure_setup(MINIMAL)
    assert TB.placement("KZG_TORCH_EVAL") == TB.placement("KZG_TORCH_PROVER") == "device"
    backend = TorchBackend(device="cpu")
    assert backend.verify_kzg_proof_pipeline(settings, comms[0], bytes(32), bytes(32), proofs[0]) is NotImplemented
    assert backend.verify_blob_pipeline(settings, blobs[0], comms[0], proofs[0]) is NotImplemented
    assert backend.compute_blob_proof_pipeline(settings, blobs[0], comms[0]) is NotImplemented
    assert "verify_native" not in settings._device_cache and "prover_native" not in settings._device_cache


def test_host_without_engine_raises(monkeypatch, minimal_batch):
    """KZG_TORCH_NATIVE=0: the wrappers fall back to golden, require()
    raises, and host placement raises RuntimeError on every pipeline."""
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_load_failed", False)
    monkeypatch.setattr(nat, "BUILD_INFO", {})
    monkeypatch.setenv("KZG_TORCH_NATIVE", "0")
    assert not nat.available()
    with pytest.raises(RuntimeError, match="KZG_TORCH_NATIVE=0"):
        nat.require()
    p = rand_g1()
    assert hostcrypto.g1_mul(p, 9) == gc.g1_mul(p, 9)
    assert hostcrypto.verify_ctx([1], None, None, b"", b"") is None
    _, _, blobs, comms, proofs = minimal_batch
    settings = make_insecure_setup(MINIMAL)
    backend = TorchBackend(device="cpu")
    calls = {
        "KZG_TORCH_EVAL": [
            lambda: backend.verify_blob_batch_pipeline(settings, blobs, comms, proofs),
            lambda: backend.verify_kzg_proof_pipeline(settings, comms[0], bytes(32), bytes(32), proofs[0]),
            lambda: backend.verify_blob_pipeline(settings, blobs[0], comms[0], proofs[0]),
        ],
        "KZG_TORCH_PROVER": [
            lambda: backend.blob_to_commitment_pipeline(settings, blobs[0]),
            lambda: backend.compute_kzg_proof_pipeline(settings, blobs[0], 5),
            lambda: backend.compute_blob_proof_pipeline(settings, blobs[0], comms[0]),
        ],
    }
    for var, fns in calls.items():
        monkeypatch.setenv(var, "host")
        for fn in fns:
            with pytest.raises(RuntimeError, match=f"{var}=host"):
                fn()


def test_card_backend_requires_the_engine(monkeypatch):
    """On a CUDA device the constructor loads the engine and raises where it
    does not load, so a card run never ends in the golden pairing unasked;
    the CPU and KZG_TORCH_NATIVE=0 keep the golden fallback."""
    monkeypatch.setattr(TB.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TB.torch.cuda, "current_device", lambda: 0)
    assert TorchBackend().device == TB.torch.device("cuda", 0)  # the engine loads
    monkeypatch.setattr(nat, "_load", lambda: None)
    for make in (TorchBackend, lambda: TorchBackend(device="cuda")):
        with pytest.raises(RuntimeError, match="native host engine not available"):
            make()
    assert TorchBackend(device="cpu").device.type == "cpu"
    monkeypatch.setenv("KZG_TORCH_NATIVE", "0")
    assert TorchBackend().device.type == "cuda"


def test_setup_cache_sweeps_the_subgroup_in_the_engine(monkeypatch):
    """A cached setup with an on-curve G1 point outside the subgroup passes
    the cheap checks and is refused by the engine's subgroup sweep."""
    from kzg_rust_tpu_torch import settings as S

    st = make_insecure_setup(MINIMAL)
    g1 = list(st.g1_values)
    g1[3] = _off_subgroup_point()
    assert S._validate_cached_points(st.g1_values, st.g2_values, 4, 2) is True
    assert S._validate_cached_points(g1, st.g2_values, 4, 2) is False
    monkeypatch.setattr(nat, "available", lambda: False)
    assert S._validate_cached_points(g1, st.g2_values, 4, 2) is True  # the JAX package's rule without an engine


def test_library_in_the_port_build_dir():
    path = nat.BUILD_INFO["path"]
    assert path == nat.library_path()
    assert os.path.dirname(path) == _build.build_dir()
    if not os.environ.get("KZG_TORCH_BUILD_DIR"):
        assert pathlib.Path(path).parent == REPO_ROOT / "kzg_rust_tpu_torch" / "build"
    assert "kzg_rust_tpu_torch" in path and ".cache" not in path
    assert not os.path.samefile(path, jnat._build())  # not the JAX package's library
    assert nat.ENTRY_POINTS.keys() >= {"kzg_pairings_verify", "kzg_verify_blob_batch_ptrs", "kzg_prover_blob_proof"}


def test_engine_threads_beside_the_hash_pool(minimal_batch):
    """The engine's calls drop the GIL: engine verifications on more threads
    than cores, beside the port's SHA-256 pool, all give the right answers."""
    from kzg_rust_tpu_torch.utils import bls_serde as serde

    settings, _, blobs, comms, proofs = minimal_batch
    ctx = TorchBackend(device="cpu")._verify_native_ctx(settings)
    c, good, swapped = b"".join(comms), b"".join(proofs), b"".join([proofs[1], proofs[0], proofs[2]])
    # Mainnet-sized preimages, which hashlib hashes without the GIL.
    preimages = [serde.challenge_preimage(MAINNET, rng.randbytes(MAINNET.bytes_per_blob), comms[i % 3]) for i in range(64)]
    want_zs = [serde.hash_to_bls_field_sha(m) for m in preimages]
    results, errors = [], []

    def verify_many():
        try:
            for _ in range(20):
                results.append((ctx.verify_scatter(blobs, 3, c, good), ctx.verify_scatter(blobs, 3, c, swapped)))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=verify_many) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        zs = [list(TB._hash_pool().map(serde.hash_to_bls_field_sha, preimages)) for _ in range(5)]
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert results == [(True, False)] * (20 * len(threads))
    assert zs == [want_zs] * 5


# ---------------------------------------------------------------------------
# The preset modules (the port's counterpart of tests/test_preset_modules.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod", [kzg_mainnet, kzg_minimal], ids=["mainnet", "minimal"])
def test_preset_module_blob(mod):
    raw = b"\x00" * mod.BYTES_PER_BLOB
    assert len(mod.Blob(raw)) == mod.BYTES_PER_BLOB
    with pytest.raises(InvalidBytesLength):
        mod.Blob(raw[:-32])
    assert isinstance(mod.Blob.from_bytes(bytearray(raw)), mod.Blob)
    assert isinstance(mod.Blob.from_hex("0x" + raw.hex()), mod.Blob)


def test_preset_module_loaders(tmp_path):
    assert (kzg_mainnet.FIELD_ELEMENTS_PER_BLOB, kzg_minimal.FIELD_ELEMENTS_PER_BLOB) == (4096, 4)
    assert kzg_mainnet.Kzg.PRESET is not kzg_minimal.Kzg.PRESET
    path = tmp_path / "minimal_setup.txt"
    write_insecure_setup_file(path, kzg_minimal.PRESET)
    assert kzg_minimal.Kzg.load_trusted_setup_file(str(path), preset=kzg_minimal.PRESET).preset.field_elements_per_blob == 4
    assert kzg_minimal.Kzg.load_trusted_setup_file(str(path)).preset.field_elements_per_blob == 4
    with pytest.raises(InvalidTrustedSetup):
        kzg_mainnet.Kzg.load_trusted_setup_file(str(path))


def test_preset_module_roundtrip_and_default_backend(monkeypatch):
    settings = make_insecure_setup(kzg_minimal.PRESET)
    blob = kzg_minimal.Blob(b"".join(i.to_bytes(32, "big") for i in (7, 11, 13, 17)))
    backend = TorchBackend(device="cpu")
    c = kzg_minimal.Kzg.blob_to_kzg_commitment(blob, settings, backend)
    z = Bytes32((5).to_bytes(32, "big"))
    proof, y = kzg_minimal.Kzg.compute_kzg_proof(blob, z, settings, backend)
    assert kzg_minimal.Kzg.verify_kzg_proof(c, z, y, proof, settings, backend) is True
    bad_y = Bytes32((int.from_bytes(bytes(y), "big") ^ 1).to_bytes(32, "big"))
    assert kzg_minimal.Kzg.verify_kzg_proof(c, z, bad_y, proof, settings, backend) is False
    bp = kzg_minimal.Kzg.compute_blob_kzg_proof(blob, c, settings, backend)
    assert kzg_minimal.Kzg.verify_blob_kzg_proof_batch([blob], [c], [bp], settings, backend) is True
    # Without a backend argument the call takes the port's default, "torch".
    asked = []
    monkeypatch.delenv("KZG_TORCH_BACKEND", raising=False)
    monkeypatch.setattr("kzg_rust_tpu_torch.api.get_backend", lambda name: asked.append(name) or backend)
    assert bytes(kzg_minimal.Kzg.blob_to_kzg_commitment(blob, settings)) == bytes(c)
    assert asked == ["torch"]
