"""The whole slice: ``Kzg.verify_blob_kzg_proof_batch`` through the port's
``TorchBackend(device="cpu")`` (the plain versions of every kernel) against
the JAX package's ``JaxBackend`` forced onto its device branch, on the same
bytes and the insecure minimal setup; plus the minimal batch vectors, the
import rule and the device rule.
"""

from __future__ import annotations

import ast
import glob
import pathlib
import random
import subprocess
import sys

import pytest
import torch
import yaml

from kzg_rust_tpu import Kzg as JKzg
from kzg_rust_tpu.backends.jax_backend import JaxBackend
from kzg_rust_tpu.errors import BadArgs as JBadArgs
from kzg_rust_tpu.presets import MINIMAL as J_MINIMAL
from kzg_rust_tpu.types import Blob as JBlob
from kzg_rust_tpu.types import Bytes48 as JBytes48
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch import Blob, Bytes48, Kzg, KzgError
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend
from kzg_rust_tpu_torch.errors import BadArgs
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P, fp_sqrt
from kzg_rust_tpu_torch.presets import MINIMAL
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

from .conftest import REPO_ROOT

rng = random.Random(0xBA7C4)
PKG = REPO_ROOT / "kzg_rust_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setups():
    return make_insecure_setup(MINIMAL), j_make_insecure_setup(J_MINIMAL)


@pytest.fixture(scope="module")
def batch(setups):
    """Three blobs with golden commitments and proofs, as raw bytes (the
    same shape as tests/test_batch_pipeline.py, so the JAX programs are the
    ones that file compiles)."""
    settings, _ = setups
    golden = GoldenBackend()
    blobs = [b"".join(b"\x00" + rng.randbytes(31) for _ in range(MINIMAL.field_elements_per_blob)) for _ in range(3)]
    cs = [bytes(Kzg.blob_to_kzg_commitment(Blob(b, bytes_per_blob=MINIMAL.bytes_per_blob), settings, golden)) for b in blobs]
    ps = [
        bytes(Kzg.compute_blob_kzg_proof(Blob(b, bytes_per_blob=MINIMAL.bytes_per_blob), Bytes48(c), settings, golden))
        for b, c in zip(blobs, cs)
    ]
    return blobs, cs, ps


def _non_subgroup_point() -> bytes:
    while True:
        x = rng.randrange(P)
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return gc.g1_compress((x, y))


def _lanes(batch):
    blobs, cs, ps = batch
    bad_blob = b"\xff" * 32 + blobs[1][32:]
    return {
        "valid": (blobs, cs, ps),
        "swapped": (blobs, cs, [ps[1], ps[0], ps[2]]),
        "noncanonical": ([blobs[0], bad_blob, blobs[2]], cs, ps),
        "malformed": (blobs, [cs[0], cs[1], b"\x11" * 48], ps),
        "non_subgroup": (blobs, [_non_subgroup_point(), cs[1], cs[2]], ps),
    }


def _outcome(fn):
    try:
        return fn()
    except (BadArgs, JBadArgs) as e:
        return type(e).__name__


@pytest.mark.parametrize("lane", ["valid", "swapped", "noncanonical", "malformed", "non_subgroup"])
def test_slice_matches_jax_device_branch(lane, setups, batch, monkeypatch):
    settings, jsettings = setups
    monkeypatch.setenv("KZG_TPU_EVAL", "device")
    blobs, cs, ps = _lanes(batch)[lane]
    n = MINIMAL.bytes_per_blob
    got = _outcome(
        lambda: Kzg.verify_blob_kzg_proof_batch(
            [Blob(b, bytes_per_blob=n) for b in blobs],
            [Bytes48(c) for c in cs],
            [Bytes48(p) for p in ps],
            settings,
            TorchBackend(device="cpu"),
        )
    )
    want = _outcome(
        lambda: JKzg.verify_blob_kzg_proof_batch(
            [JBlob(b, bytes_per_blob=n) for b in blobs],
            [JBytes48(c) for c in cs],
            [JBytes48(p) for p in ps],
            jsettings,
            JaxBackend(),
        )
    )
    expected = {"valid": True, "swapped": False}.get(lane, "BadArgs")
    assert got == want == expected


def _minimal_batch_vectors():
    files = sorted(glob.glob(str(REPO_ROOT / "tests" / "vectors_minimal" / "verify_blob_kzg_proof_batch" / "*" / "*" / "data.yaml")))
    assert files
    return [pytest.param(f, id=pathlib.Path(f).parent.name) for f in files]


@pytest.fixture(scope="module")
def minimal_file_settings():
    return Kzg.load_trusted_setup_file(REPO_ROOT / "data" / "trusted_setup_minimal.txt", MINIMAL)


@pytest.mark.parametrize("path", _minimal_batch_vectors())
def test_minimal_batch_vectors(path, minimal_file_settings):
    with open(path) as fh:
        case = yaml.safe_load(fh)
    inp, expected = case["input"], case["output"]
    n = MINIMAL.bytes_per_blob
    try:
        got = Kzg.verify_blob_kzg_proof_batch(
            [Blob.from_hex(h, bytes_per_blob=n) for h in inp["blobs"]],
            [Bytes48.from_hex(h) for h in inp["commitments"]],
            [Bytes48.from_hex(h) for h in inp["proofs"]],
            minimal_file_settings,
            TorchBackend(device="cpu"),
        )
    except KzgError:
        assert expected is None
        return
    assert got == expected


def test_import_rule():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package:
    every import statement is checked, and a fresh interpreter imports every
    module of the port and finds neither in sys.modules."""
    sources = sorted(PKG.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    for module in ("backends/placement.py", "parallel/__init__.py", "parallel/sharded.py", "parallel/distributed.py"):
        assert PKG / module in sources, module
    for src in sources:
        for node in ast.walk(ast.parse(src.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "kzg_rust_tpu"), f"{src}: imports {name}"
    code = (
        "import importlib, pkgutil, sys\n"
        "import kzg_rust_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'kzg_rust_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'kzg_rust_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('kzg_rust_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_device_rule(monkeypatch):
    """Without CUDA the default backend raises instead of running on the
    CPU; only an explicit device="cpu" runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    monkeypatch.setattr("kzg_rust_tpu_torch.backends._CACHE", {})
    monkeypatch.delenv("KZG_TORCH_BACKEND", raising=False)
    settings = make_insecure_setup(MINIMAL)
    blob = Blob(bytes(MINIMAL.bytes_per_blob), bytes_per_blob=MINIMAL.bytes_per_blob)
    inf = Bytes48(b"\xc0" + bytes(47))
    with pytest.raises(RuntimeError, match="CUDA"):
        Kzg.verify_blob_kzg_proof_batch([blob, blob], [inf, inf], [inf, inf], settings)
    assert TorchBackend(device="cpu").device.type == "cpu"
