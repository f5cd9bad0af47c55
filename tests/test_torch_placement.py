"""The port's placement layer: measured ``auto`` placement
(kzg_rust_tpu_torch.backends.placement and ``TorchBackend._auto_prefers_device``)
and the backend's binding of its card.

The profiles are patched on each side of the cut, for a batch and for the
prover; the overlapped model is held to the unsharded chunked regime,
decided on the padded npad (n = 64, 65, 127), and a sharded batch keeps
the additive model.  A CPU backend places ``auto`` on the host, ``auto``
without the engine takes the device path, the device overrides parse (and
warn where they do not), and the default is still the card.  The rule's
``cuda`` branch runs here on a CPU backend whose ``device`` says cuda:
nothing in it touches a card.  Last, every device entry point of
``TorchBackend`` runs under ``torch.cuda.device`` of the backend's card,
recorded by a stand-in for it.
"""

from __future__ import annotations

import logging
import random

import pytest
import torch

from kzg_rust_tpu_torch import Blob, Kzg
from kzg_rust_tpu_torch.backends import placement as P
from kzg_rust_tpu_torch.backends import torch_backend as TB
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend
from kzg_rust_tpu_torch.ops import msm as M
from kzg_rust_tpu_torch.ops import protocol_kernels as PK
from kzg_rust_tpu_torch.ops import verify_kernels as V
from kzg_rust_tpu_torch.presets import MAINNET, MINIMAL, Preset
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

rng = random.Random(0x9A7)
MS = 1e-3
BPB = MAINNET.bytes_per_blob


class _Settings:
    """What the rule reads of a settings object: the preset."""

    preset = MAINNET


@pytest.fixture
def profiles(monkeypatch):
    """A backend whose rule runs its cuda branch, with the profiles patched
    to the values in the returned dict (seconds, bytes/s): a link of
    0.1 ms and 10 GB/s, a host of 60 us a blob and 10 ms a proof, a card
    of 20 ms + 80 us a blob and 5 ms a proof."""
    vals = {"rtt": 0.1 * MS, "bw": 10e9, "host_blob": 60e-6, "host_prove": 10 * MS, "fixed": 20 * MS, "per_blob": 80e-6, "prove": 5 * MS}
    monkeypatch.setattr(P, "link_profile", lambda device: (vals["rtt"], vals["bw"]))
    monkeypatch.setattr(P, "host_verify_profile", lambda ctx, bpb, n: vals["host_blob"])
    monkeypatch.setattr(P, "host_prove_profile", lambda ctx, bpb: vals["host_prove"])
    monkeypatch.setattr(P, "device_verify_profile", lambda: (vals["fixed"], vals["per_blob"]))
    monkeypatch.setattr(P, "AUTO_DEVICE_PROVE_S", vals["prove"])
    backend = TorchBackend(device="cpu")
    backend.device = torch.device("cuda", 0)
    monkeypatch.setattr(backend, "_verify_native_ctx", lambda settings: object())
    monkeypatch.setattr(backend, "_prover_native_ctx", lambda settings: object())
    return backend, vals


def _verify(backend, n: int) -> bool:
    return backend._auto_prefers_device(_Settings, n, n * (BPB + 96), "verify_batch")


@pytest.mark.parametrize("n", [64, 512, 4096])
@pytest.mark.parametrize("side", ["host", "device"])
def test_verify_choice_each_side_of_the_cut(profiles, n, side):
    """The batch goes where its estimate is lower: the host at 60 us a
    blob (it beats the card's 80 us a blob and fixed 20 ms at every n);
    the card once the host costs 200 us a blob, more than the card's
    estimate a blob plus its upload."""
    backend, vals = profiles
    if side == "device":
        vals["host_blob"] = 200e-6 + 20 * MS / n
    assert _verify(backend, n) is (side == "device")
    terms = backend.last_placement
    assert terms["choice"] == side and terms["op"] == "verify_batch" and terms["n"] == n
    assert terms["host_budget_ms"] == pytest.approx(n * vals["host_blob"] / MS)


@pytest.mark.parametrize("side", ["host", "device"])
def test_prover_choice_each_side_of_the_cut(profiles, side):
    """A prover call goes to the card when its 5 ms proof, a blob's upload
    and the round trips beat the host's measured proof (10 ms), to the
    host when the host's takes 4 ms; ``_prover_mode`` resolves it."""
    backend, vals = profiles
    if side == "host":
        vals["host_prove"] = 4 * MS
    assert backend._auto_prefers_device(_Settings, 1, BPB, "prover") is (side == "device")
    terms = backend.last_placement
    assert terms["device_est_ms"] == pytest.approx(5.0) and not terms["overlapped"] and not terms["sharded"]
    assert terms["combined_ms"] == pytest.approx(2.5 * vals["rtt"] / MS + BPB / vals["bw"] / MS + 5.0)


def test_prover_mode_resolves_auto(profiles, monkeypatch):
    backend, vals = profiles
    monkeypatch.setenv("KZG_TORCH_PROVER", "auto")
    assert backend._prover_mode(_Settings) == "device"
    vals["host_prove"] = 4 * MS
    assert backend._prover_mode(_Settings) == "host"
    monkeypatch.setenv("KZG_TORCH_PROVER", "device")
    assert backend._prover_mode(_Settings) == "device"


@pytest.mark.parametrize("n, npad, overlapped", [(64, 64, False), (65, 128, True), (127, 128, True)])
def test_overlap_follows_npad(profiles, n, npad, overlapped):
    """The overlapped model holds from npad >= 2 * BARY_CHUNK_BLOBS, as
    ``_verify_batch_device`` decides the chunked regime: n = 65..127 pad to
    128 and overlap, n = 64 does not.  With a slow link (the upload above
    the card's time) the two models give different estimates."""
    backend, vals = profiles
    vals["bw"] = 0.2e9
    assert TB._pow2_pad(n, lo=4) == npad and (npad >= 2 * TB.BARY_CHUNK_BLOBS) is overlapped
    _verify(backend, n)
    terms = backend.last_placement
    upload, dev = terms["upload_ms"], terms["device_est_ms"]
    assert upload > dev
    assert terms["overlapped"] is overlapped and not terms["sharded"]
    assert terms["combined_ms"] == pytest.approx(2.5 * vals["rtt"] / MS + (max(upload, dev) if overlapped else upload + dev))


def test_sharded_batch_keeps_the_additive_model(profiles, monkeypatch):
    """A batch on a blob mesh uploads in one transfer: even in the chunked
    regime's range its estimate is the sum."""
    backend, _ = profiles
    monkeypatch.setattr(backend, "_batch_mesh", lambda npad: [torch.device("cuda", 0), torch.device("cuda", 1)])
    _verify(backend, 512)
    terms = backend.last_placement
    assert terms["sharded"] and not terms["overlapped"]
    assert terms["combined_ms"] == pytest.approx(2.5 * 0.1 + terms["upload_ms"] + terms["device_est_ms"])


def test_decision_logged_once_per_outcome(profiles, caplog):
    backend, vals = profiles
    with caplog.at_level(logging.INFO, logger="kzg_rust_tpu_torch"):
        for _ in range(3):
            _verify(backend, 64)
        vals["host_blob"] = 1.0
        _verify(backend, 64)
    lines = [r.getMessage() for r in caplog.records if "placement auto" in r.getMessage()]
    assert len(lines) == 2 and lines[0].endswith("-> host") and lines[1].endswith("-> device")


@pytest.fixture(scope="module")
def minimal_batch():
    settings = make_insecure_setup(MINIMAL)
    golden = GoldenBackend()
    blobs = [Blob(b"".join(b"\x00" + rng.randbytes(31) for _ in range(4)), bytes_per_blob=MINIMAL.bytes_per_blob) for _ in range(2)]
    cs = [Kzg.blob_to_kzg_commitment(b, settings, golden) for b in blobs]
    ps = [Kzg.compute_blob_kzg_proof(b, c, settings, golden) for b, c in zip(blobs, cs)]
    return settings, blobs, cs, ps


def _no_device(monkeypatch):
    def device(*_a, **_k):
        raise AssertionError("auto reached a device path")

    for name in ("_verify_batch_device", "_msm_ctx", "barycentric_eval"):
        monkeypatch.setattr(TorchBackend, name, device)


def test_cpu_backend_auto_is_the_host(monkeypatch, minimal_batch):
    """On a CPU backend ``auto`` takes the engine for every call, with no
    profile measured, as the JAX backend does on a CPU platform."""
    settings, blobs, cs, ps = minimal_batch
    monkeypatch.setenv("KZG_TORCH_EVAL", "auto")
    monkeypatch.setenv("KZG_TORCH_PROVER", "auto")
    monkeypatch.setattr(P, "link_profile", lambda device: pytest.fail("profiled on a CPU backend"))
    _no_device(monkeypatch)
    backend = TorchBackend(device="cpu")
    assert Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps, settings, backend) is True
    assert Kzg.verify_blob_kzg_proof_batch(blobs, cs, ps[::-1], settings, backend) is False
    assert bytes(Kzg.blob_to_kzg_commitment(blobs[0], settings, backend)) == bytes(cs[0])
    assert Kzg.verify_blob_kzg_proof(blobs[1], cs[1], ps[1], settings, backend) is True
    assert backend._prover_mode(settings) == "host" and backend.last_placement == {}


def test_auto_without_engine_takes_the_device(monkeypatch, minimal_batch):
    """Without the engine ``auto`` is the device path for the batch and the
    prover, and the single verifications fall to the protocol's path."""
    settings, blobs, cs, ps = minimal_batch
    monkeypatch.setenv("KZG_TORCH_EVAL", "auto")
    monkeypatch.setenv("KZG_TORCH_PROVER", "auto")
    backend = TorchBackend(device="cpu")
    monkeypatch.setattr(backend, "_verify_native_ctx", lambda settings: None)
    monkeypatch.setattr(backend, "_prover_native_ctx", lambda settings: None)
    calls = []
    monkeypatch.setattr(backend, "_verify_batch_device", lambda *a: calls.append("batch") or True)
    assert backend.verify_blob_batch_pipeline(settings, blobs, cs, ps) is True and calls == ["batch"]
    assert backend._prover_mode(settings) == "device"
    assert backend.verify_blob_pipeline(settings, blobs[0], cs[0], ps[0]) is NotImplemented
    assert backend.verify_kzg_proof_pipeline(settings, cs[0], bytes(32), bytes(32), ps[0]) is NotImplemented


def test_device_overrides(monkeypatch, caplog):
    """KZG_TORCH_DEVICE_FIXED_MS and KZG_TORCH_DEVICE_PER_BLOB_US replace
    the H100 constants; an unparseable one falls back to them with a
    warning."""
    monkeypatch.setattr(P, "_HOST_PROFILE", {})
    assert P.device_verify_profile() == (P.AUTO_DEVICE_FIXED_S, P.AUTO_DEVICE_PER_BLOB_S)
    monkeypatch.setenv(P.FIXED_ENV, "5")
    monkeypatch.setenv(P.PER_BLOB_ENV, "100")
    assert P.device_verify_profile() == pytest.approx((5e-3, 100e-6))
    assert P.device_est(10, "verify_batch") == pytest.approx(6e-3)
    assert P.device_est(10, "prover") == P.AUTO_DEVICE_PROVE_S
    monkeypatch.setenv(P.PER_BLOB_ENV, "fast")
    with caplog.at_level(logging.WARNING, logger="kzg_rust_tpu_torch"):
        assert P.device_verify_profile() == (P.AUTO_DEVICE_FIXED_S, P.AUTO_DEVICE_PER_BLOB_S)
    assert any("unparseable" in r.getMessage() for r in caplog.records)


def test_host_profiles_measure_the_engine(monkeypatch, minimal_batch, caplog):
    """The host profiles time the engine's contexts (positive; a batch once
    per preset and padded size, capped at HOST_CALIB_MAX_BLOBS), and fall
    back to their constants with a warning where the calibration fails."""
    settings = minimal_batch[0]
    monkeypatch.setattr(P, "_HOST_PROFILE", {})
    monkeypatch.setattr(P, "HOST_CALIB_MAX_BLOBS", 8)
    backend = TorchBackend(device="cpu")
    bpb = MINIMAL.bytes_per_blob
    per_blob = P.host_verify_profile(backend._verify_native_ctx(settings), bpb, 3)
    assert 0 < per_blob < 1
    assert P.host_verify_profile(None, bpb, 4) == per_blob  # 3 and 4 pad to 4: cached
    big = P.host_verify_profile(backend._verify_native_ctx(settings), bpb, 100)
    assert 0 < big < 1 and P.host_verify_profile(None, bpb, 5000) == big  # both timed at 8
    assert sorted(k[2] for k in P._HOST_PROFILE if k[0] == "verify") == [4, 8]
    t16 = make_insecure_setup(Preset(name="t16", field_elements_per_blob=16))
    assert 0 < P.host_prove_profile(backend._prover_native_ctx(t16), 16 * 32) < 1

    class Broken:
        def verify_scatter(self, *a):
            raise RuntimeError("no engine")

    with caplog.at_level(logging.WARNING, logger="kzg_rust_tpu_torch"):
        assert P.host_verify_profile(Broken(), 64, 2) == P.AUTO_HOST_PER_BLOB_S
        assert P.host_prove_profile(Broken(), 64) == P.AUTO_HOST_PROVE_S
    assert sum("calibration failed" in r.getMessage() for r in caplog.records) == 2


def test_default_is_the_card(monkeypatch, minimal_batch):
    """Unset, both variables mean the card, and ``auto`` and
    ``host-piecewise`` are values of their own: on the minimal batch
    ``host-piecewise`` gives host placement's answers without the device
    path, and on the prover it is the device; unknown values raise."""
    monkeypatch.delenv("KZG_TORCH_EVAL", raising=False)
    monkeypatch.delenv("KZG_TORCH_PROVER", raising=False)
    assert TB.placement("KZG_TORCH_EVAL") == TB.placement("KZG_TORCH_PROVER") == "device"
    for mode in ("auto", "host-piecewise"):
        monkeypatch.setenv("KZG_TORCH_EVAL", mode)
        assert TB.placement("KZG_TORCH_EVAL") == mode
    settings, blobs, cs, ps = minimal_batch
    backend = TorchBackend(device="cpu")
    for cs_ in (cs, cs[::-1]):
        monkeypatch.setenv("KZG_TORCH_EVAL", "host")
        want = backend.verify_blob_batch_pipeline(settings, blobs, cs_, ps)
        monkeypatch.setenv("KZG_TORCH_EVAL", "host-piecewise")
        monkeypatch.setattr(backend, "_verify_batch_device", lambda *a: pytest.fail("host-piecewise reached the device path"))
        assert backend.verify_blob_batch_pipeline(settings, blobs, cs_, ps) is want is (cs_ is cs)
    monkeypatch.setenv("KZG_TORCH_PROVER", "host-piecewise")
    assert backend._prover_mode(settings) == "device"
    monkeypatch.setenv("KZG_TORCH_EVAL", "tpu")
    with pytest.raises(ValueError, match="expected one of device, host, auto, host-piecewise"):
        TB.placement("KZG_TORCH_EVAL")


def test_mesh_rule(monkeypatch):
    """``_auto_mesh``: the largest power of two of visible cards that
    divides n, from the backend's card on; none on the CPU, with one card,
    or with KZG_TORCH_SHARD=0."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    backend = TorchBackend(device="cpu")
    assert backend._batch_mesh(64) is None  # a CPU backend
    backend.device = torch.device("cuda", 1)
    cuda = [torch.device("cuda", i) for i in (1, 2, 3, 0)]
    assert backend._batch_mesh(64) == cuda
    assert backend._points_mesh(4096) == cuda and backend._domain_mesh(4096) == cuda
    assert backend._batch_mesh(6) == cuda[:2] and backend._batch_mesh(5) is None
    monkeypatch.setenv("KZG_TORCH_SHARD", "0")
    assert backend._batch_mesh(64) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("KZG_TORCH_SHARD")
    assert TorchBackend(device="cpu")._auto_mesh(64, "blobs") is None


# ---------------------------------------------------------------------------
# The backend binds its card
# ---------------------------------------------------------------------------


class _DeviceRecorder:
    """A stand-in for ``torch.cuda.device``: records each device entered and
    the nesting depth."""

    entered: list = []
    depth = 0

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        type(self).entered.append(str(self.device))
        type(self).depth += 1

    def __exit__(self, *exc):
        type(self).depth -= 1


@pytest.fixture
def bound_backend(monkeypatch):
    """A backend whose ``device`` is cuda:1, with ``torch.cuda.device``
    recorded and the context builders replaced by stand-ins that record
    the depth they were built at."""
    monkeypatch.setattr(torch.cuda, "device", _DeviceRecorder)
    monkeypatch.setattr(_DeviceRecorder, "entered", [])
    built = {}

    def builder(name):
        def build(*_a, **_k):
            built[name] = _DeviceRecorder.depth
            raise _Stop(name)

        return build

    monkeypatch.setattr(PK.FrContext, "build", builder("fr_ctx"))
    monkeypatch.setattr(M.MsmContext, "build", builder("msm"))
    monkeypatch.setattr(V, "build_generator_table", builder("gen_table"))
    backend = TorchBackend(device="cpu")
    backend.device = torch.device("cuda", 1)
    return backend, built


class _Stop(Exception):
    pass


T16 = Preset(name="t16", field_elements_per_blob=16)


ENTRY_POINTS = (
    "verify_blob_batch_pipeline",
    "_verify_batch_device",
    "blob_to_commitment_pipeline",
    "compute_kzg_proof_pipeline",
    "compute_blob_proof_pipeline",
    "msm_g1_lagrange",
    "barycentric_eval",
    "quotient_out_of_domain",
    "quotient_in_domain",
    "_fr_ctx",
    "_msm_ctx",
    "_gen_table",
)


@pytest.fixture(scope="module")
def entry_calls():
    """Each device entry point with arguments that reach its first device
    step (the minimal preset's blob length, a 16-point preset for the
    MSM)."""
    settings, t16 = make_insecure_setup(MINIMAL), make_insecure_setup(T16)
    blob = bytes(MINIMAL.bytes_per_blob)
    inf = b"\xc0" + bytes(47)
    return {
        "verify_blob_batch_pipeline": lambda b: b.verify_blob_batch_pipeline(settings, [blob], [inf], [inf]),
        "_verify_batch_device": lambda b: b._verify_batch_device(settings, [blob], [inf], [inf]),
        "blob_to_commitment_pipeline": lambda b: b.blob_to_commitment_pipeline(t16, bytes(16 * 32)),
        "compute_kzg_proof_pipeline": lambda b: b.compute_kzg_proof_pipeline(t16, bytes(16 * 32), 5),
        "compute_blob_proof_pipeline": lambda b: b.compute_blob_proof_pipeline(t16, bytes(16 * 32), inf),
        "msm_g1_lagrange": lambda b: b.msm_g1_lagrange(t16, [1] * 16),
        "barycentric_eval": lambda b: b.barycentric_eval(settings, [1, 2, 3, 4], 5),
        "quotient_out_of_domain": lambda b: b.quotient_out_of_domain(settings, [1, 2, 3, 4], 5, 6),
        "quotient_in_domain": lambda b: b.quotient_in_domain(settings, [1, 2, 3, 4], settings.roots_of_unity[0], 1, 0),
        "_fr_ctx": lambda b: b._fr_ctx(settings),
        "_msm_ctx": lambda b: b._msm_ctx(t16),
        "_gen_table": lambda b: b._gen_table(),
    }


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_bind_the_card(bound_backend, entry_calls, name):
    """Each entry point enters the backend's card (cuda:1) before its first
    device step and leaves it after, whether it returns or raises; the
    contexts are built inside it."""
    backend, built = bound_backend
    call = entry_calls[name]
    try:
        call(backend)
    except Exception:  # the device steps fail here, after the entry
        pass
    assert _DeviceRecorder.entered and _DeviceRecorder.entered[0] == "cuda:1", name
    assert _DeviceRecorder.depth == 0
    assert all(depth >= 1 for depth in built.values()), built
