"""The prover slice: ``blob_to_kzg_commitment``, ``compute_kzg_proof`` and
``compute_blob_kzg_proof`` through the port's ``TorchBackend(device="cpu")``
(the plain versions of every kernel) against the JAX package's device
pipelines (``commit_kernel`` / ``proof_kernel``, forced with
``KZG_TPU_PROVER=device``) and the golden backend, on a 16-point insecure
setup with the same tau in both packages; plus the single-blob
barycentric evaluation of ``verify_blob_kzg_proof``, the backend's
piecewise polynomial math, and the minimal preset's host MSM path.
"""

from __future__ import annotations

import ctypes
import random
from gc import collect as collect_garbage

import jax
import pytest
import torch

from kzg_rust_tpu import Kzg as JKzg
from kzg_rust_tpu.backends.jax_backend import JaxBackend
from kzg_rust_tpu.errors import BadArgs as JBadArgs
from kzg_rust_tpu.presets import Preset as JPreset
from kzg_rust_tpu.types import Blob as JBlob
from kzg_rust_tpu.types import Bytes32 as JBytes32
from kzg_rust_tpu.types import Bytes48 as JBytes48
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch import Blob, Bytes32, Bytes48, Kzg
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend
from kzg_rust_tpu_torch.errors import BadArgs
from kzg_rust_tpu_torch.golden.field import R
from kzg_rust_tpu_torch.ops import prover_kernels as PR
from kzg_rust_tpu_torch.presets import MINIMAL, Preset
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

rng = random.Random(0x9207E)
N = 16
PRESET = Preset(name="t16", field_elements_per_blob=N)


@pytest.fixture(autouse=True, scope="module")
def _worker_resources():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores.  At
    the end the module's compiled JAX programs are dropped and the freed
    heap goes back to the OS: the suite's workers share one machine's
    memory, and a worker keeps what it holds into its next file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    collect_garbage()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


@pytest.fixture(scope="module")
def setups():
    return make_insecure_setup(PRESET), j_make_insecure_setup(JPreset(name="t16", field_elements_per_blob=N))


@pytest.fixture(scope="module")
def blob():
    return b"".join(b"\x00" + rng.randbytes(31) for _ in range(N))


def _zs(settings):
    return {"out_of_domain": rng.randrange(R), "root_0": settings.roots_of_unity[0], "root_5": settings.roots_of_unity[5]}


@pytest.fixture(scope="module")
def expected(setups, blob):
    """Golden commitment and proofs, made before any test patches the
    golden backend."""
    settings, _ = setups
    g = GoldenBackend()
    b = Blob(blob, bytes_per_blob=PRESET.bytes_per_blob)
    c = bytes(Kzg.blob_to_kzg_commitment(b, settings, g))
    zs = _zs(settings)
    proofs = {}
    for name, z in zs.items():
        p, y = Kzg.compute_kzg_proof(b, Bytes32(z.to_bytes(32, "big")), settings, g)
        proofs[name] = (z, bytes(p), bytes(y))
    return {"commitment": c, "proofs": proofs, "blob_proof": bytes(Kzg.compute_blob_kzg_proof(b, Bytes48(c), settings, g))}


@pytest.fixture
def device_only(monkeypatch):
    """The golden MSM and the host quotient loops raise, and the device
    pipelines count their calls: a test that passes ran the port's path."""

    def refuse(*a, **k):
        raise AssertionError("host path taken")

    for name in ("msm_g1_lagrange", "quotient_out_of_domain", "quotient_in_domain", "barycentric_eval"):
        monkeypatch.setattr(GoldenBackend, name, refuse)
    calls = {"commit": 0, "proof": 0}
    for name in calls:
        real = getattr(PR, name)

        def counted(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(PR, name, counted)
    return calls


@pytest.fixture
def jax_device(monkeypatch):
    monkeypatch.setenv("KZG_TPU_PROVER", "device")
    return JaxBackend()


def test_commitment_matches_jax_and_golden(setups, blob, expected, device_only, jax_device):
    settings, jsettings = setups
    got = Kzg.blob_to_kzg_commitment(Blob(blob, bytes_per_blob=PRESET.bytes_per_blob), settings, TorchBackend(device="cpu"))
    assert device_only == {"commit": 1, "proof": 0}
    want = JKzg.blob_to_kzg_commitment(JBlob(blob, bytes_per_blob=PRESET.bytes_per_blob), jsettings, jax_device)
    assert bytes(got) == bytes(want) == expected["commitment"]


@pytest.mark.parametrize("zcase", ["out_of_domain", "root_0", "root_5"])
def test_compute_kzg_proof_matches_jax_and_golden(zcase, setups, blob, expected, device_only, jax_device):
    settings, jsettings = setups
    z, proof, y = expected["proofs"][zcase]
    zb = z.to_bytes(32, "big")
    got = Kzg.compute_kzg_proof(Blob(blob, bytes_per_blob=PRESET.bytes_per_blob), Bytes32(zb), settings, TorchBackend(device="cpu"))
    assert device_only == {"commit": 0, "proof": 1}
    want = JKzg.compute_kzg_proof(JBlob(blob, bytes_per_blob=PRESET.bytes_per_blob), JBytes32(zb), jsettings, jax_device)
    assert (bytes(got[0]), bytes(got[1])) == (bytes(want[0]), bytes(want[1])) == (proof, y)
    if zcase != "out_of_domain":
        m = settings.roots_of_unity.index(z)
        assert y == blob[32 * m : 32 * m + 32]


def test_compute_blob_kzg_proof_matches_jax_and_golden(setups, blob, expected, device_only, jax_device):
    settings, jsettings = setups
    c = expected["commitment"]
    got = Kzg.compute_blob_kzg_proof(Blob(blob, bytes_per_blob=PRESET.bytes_per_blob), Bytes48(c), settings, TorchBackend(device="cpu"))
    assert device_only == {"commit": 0, "proof": 1}
    want = JKzg.compute_blob_kzg_proof(JBlob(blob, bytes_per_blob=PRESET.bytes_per_blob), JBytes48(c), jsettings, jax_device)
    assert bytes(got) == bytes(want) == expected["blob_proof"]


@pytest.mark.parametrize("call", ["commit", "proof"])
def test_noncanonical_blob_raises_in_both(call, setups, blob, jax_device):
    settings, jsettings = setups
    bad = blob[:32 * 7] + b"\xff" * 32 + blob[32 * 8 :]
    z = (5).to_bytes(32, "big")
    if call == "commit":
        port = lambda: Kzg.blob_to_kzg_commitment(Blob(bad, bytes_per_blob=PRESET.bytes_per_blob), settings, TorchBackend(device="cpu"))  # noqa: E731
        jax = lambda: JKzg.blob_to_kzg_commitment(JBlob(bad, bytes_per_blob=PRESET.bytes_per_blob), jsettings, jax_device)  # noqa: E731
    else:
        port = lambda: Kzg.compute_kzg_proof(Blob(bad, bytes_per_blob=PRESET.bytes_per_blob), Bytes32(z), settings, TorchBackend(device="cpu"))  # noqa: E731
        jax = lambda: JKzg.compute_kzg_proof(JBlob(bad, bytes_per_blob=PRESET.bytes_per_blob), JBytes32(z), jsettings, jax_device)  # noqa: E731
    with pytest.raises(BadArgs) as got:
        port()
    with pytest.raises(JBadArgs) as want:
        jax()
    assert str(got.value) == str(want.value)


def test_blob_length_raises(setups, blob):
    settings, _ = setups
    backend = TorchBackend(device="cpu")
    with pytest.raises(BadArgs):
        backend.blob_to_commitment_pipeline(settings, blob[:-32])
    with pytest.raises(BadArgs):
        backend.compute_kzg_proof_pipeline(settings, blob + bytes(32), 5)


def test_verify_blob_kzg_proof_device_barycentric(setups, blob, expected, monkeypatch):
    """verify_blob_kzg_proof's evaluation at the challenge runs on the
    port's barycentric kernels (the golden one raises)."""
    settings, _ = setups
    monkeypatch.setattr(GoldenBackend, "barycentric_eval", lambda *a: pytest.fail("host barycentric evaluation"))
    b = Blob(blob, bytes_per_blob=PRESET.bytes_per_blob)
    c, p = Bytes48(expected["commitment"]), Bytes48(expected["blob_proof"])
    backend = TorchBackend(device="cpu")
    assert Kzg.verify_blob_kzg_proof(b, c, p, settings, backend) is True
    assert Kzg.verify_blob_kzg_proof(b, c, Bytes48(expected["proofs"]["root_0"][1]), settings, backend) is False


@pytest.mark.parametrize("op", ["barycentric_eval", "quotient_out_of_domain", "quotient_in_domain", "msm_g1_lagrange"])
def test_piecewise_math_matches_golden(op, setups, blob):
    """The backend's polynomial math and MSM on their own, as the piecewise
    protocol path calls them, against the golden backend's."""
    settings, _ = setups
    evals = [int.from_bytes(blob[32 * i : 32 * i + 32], "big") for i in range(N)]
    z = rng.randrange(R)
    args = {
        "barycentric_eval": (evals, z),
        "quotient_out_of_domain": (evals, z, rng.randrange(R)),
        "quotient_in_domain": (evals, settings.roots_of_unity[3], evals[3], 3),
        "msm_g1_lagrange": ([rng.randrange(R) for _ in range(N)],),
    }[op]
    got = getattr(TorchBackend(device="cpu"), op)(settings, *args)
    assert got == getattr(GoldenBackend(), op)(settings, *args)


def test_minimal_preset_takes_host_msm_and_equals_golden():
    """Below 8 points there is no table: the pipelines decline and the
    piecewise path (device polynomial math, golden MSM) gives golden's
    bytes."""
    settings = make_insecure_setup(MINIMAL)
    backend, golden = TorchBackend(device="cpu"), GoldenBackend()
    assert backend._msm_ctx(settings) is None
    data = b"".join(b"\x00" + rng.randbytes(31) for _ in range(MINIMAL.field_elements_per_blob))
    b = Blob(data, bytes_per_blob=MINIMAL.bytes_per_blob)
    assert backend.blob_to_commitment_pipeline(settings, data) is NotImplemented
    c = Kzg.blob_to_kzg_commitment(b, settings, backend)
    assert c == Kzg.blob_to_kzg_commitment(b, settings, golden)
    for z in (rng.randrange(R), settings.roots_of_unity[2]):
        zb = Bytes32(z.to_bytes(32, "big"))
        assert Kzg.compute_kzg_proof(b, zb, settings, backend) == Kzg.compute_kzg_proof(b, zb, settings, golden)
    assert Kzg.compute_blob_kzg_proof(b, Bytes48(bytes(c)), settings, backend) == Kzg.compute_blob_kzg_proof(
        b, Bytes48(bytes(c)), settings, golden
    )
