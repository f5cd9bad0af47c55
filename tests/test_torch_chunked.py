"""The chunked regime of the port's batch verification: stage 1 and the
barycentric evaluation in blob chunks (``torch_backend.STAGE1_CHUNK_BLOBS``
and ``BARY_CHUNK_BLOBS``, patched to 2 here), through
``TorchBackend(device="cpu")`` (the plain versions; on the CPU the chunk
loop runs without pinning, copy stream or graph), against the JAX
package's ``JaxBackend`` on its device branch with its own chunk widths
patched alike, and against the port's full-width path word for word; plus
the error order across chunks and the challenge hashing.
"""

from __future__ import annotations

import ctypes
import random
from gc import collect as collect_garbage

import jax
import pytest
import torch

import kzg_rust_tpu.backends.jax_backend as jb
from kzg_rust_tpu import Kzg as JKzg
from kzg_rust_tpu.backends.jax_backend import JaxBackend
from kzg_rust_tpu.errors import BadArgs as JBadArgs
from kzg_rust_tpu.presets import MINIMAL as J_MINIMAL
from kzg_rust_tpu.types import Blob as JBlob
from kzg_rust_tpu.types import Bytes48 as JBytes48
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch import Blob, Bytes48, Kzg
from kzg_rust_tpu_torch.backends import torch_backend as TB
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.errors import BadArgs
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P, fp_sqrt
from kzg_rust_tpu_torch.messages import MSG_INVALID_COMPRESSED_G1
from kzg_rust_tpu_torch.ops import verify_kernels as V
from kzg_rust_tpu_torch.presets import MINIMAL
from kzg_rust_tpu_torch.utils import bls_serde as serde
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

rng = random.Random(0xC4A2)
WIDTH = 2  # both chunk widths, in both packages
BPB = MINIMAL.bytes_per_blob


@pytest.fixture(autouse=True, scope="module")
def _worker_resources():
    """One intra-op thread per test worker; at the end the module's compiled
    JAX programs are dropped and the freed heap goes back to the OS."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    collect_garbage()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


@pytest.fixture
def chunked(monkeypatch):
    """Both packages at chunk width 2, the JAX package on its device branch."""
    monkeypatch.setenv("KZG_TPU_EVAL", "device")
    for mod in (TB, jb):
        monkeypatch.setattr(mod, "BARY_CHUNK_BLOBS", WIDTH)
        monkeypatch.setattr(mod, "STAGE1_CHUNK_BLOBS", WIDTH)


@pytest.fixture(scope="module")
def stage1_memo():
    """Stage 1's outputs by its input rows, shared by the module's tests: the
    plain stage 1 costs seconds a call on the CPU whatever its width, and
    the lanes repeat most chunks.  It is deterministic, so a repeated chunk
    gets the words it would get again."""
    return {}


@pytest.fixture(scope="module")
def setups():
    return make_insecure_setup(MINIMAL), j_make_insecure_setup(J_MINIMAL)


@pytest.fixture(scope="module")
def triples(setups):
    """Nine blobs with golden commitments and proofs, as raw bytes."""
    settings, _ = setups
    golden = GoldenBackend()
    blobs = [b"".join(b"\x00" + rng.randbytes(31) for _ in range(MINIMAL.field_elements_per_blob)) for _ in range(9)]
    cs = [bytes(Kzg.blob_to_kzg_commitment(Blob(b, bytes_per_blob=BPB), settings, golden)) for b in blobs]
    ps = [bytes(Kzg.compute_blob_kzg_proof(Blob(b, bytes_per_blob=BPB), Bytes48(c), settings, golden)) for b, c in zip(blobs, cs)]
    return blobs, cs, ps


def _non_subgroup_point() -> bytes:
    while True:
        x = rng.randrange(P)
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return gc.g1_compress((x, y))


def _lane(triples, n, lane):
    """The lane's batch of n blobs; its bad row is the last blob, in the
    batch's last (short, at n = 5 and 9) chunk."""
    blobs, cs, ps = (list(x[:n]) for x in triples)
    bad = n - 1
    if lane == "swapped":
        ps[bad], ps[0] = ps[0], ps[bad]
    elif lane == "noncanonical":
        blobs[bad] = b"\xff" * 32 + blobs[bad][32:]
    elif lane == "malformed":
        cs[bad] = b"\x11" * 48
    elif lane == "non_subgroup":
        cs[bad] = _non_subgroup_point()
    return blobs, cs, ps


def _port(settings, blobs, cs, ps, backend):
    """The port's outcome and the words of its packed fetch (flags, blob
    flag, ys)."""
    fetched = []
    real = backend._fetch

    def recording(*parts):
        fetched.append(real(*parts))
        return fetched[-1]

    backend._fetch = recording
    try:
        outcome = Kzg.verify_blob_kzg_proof_batch(
            [Blob(b, bytes_per_blob=BPB) for b in blobs], [Bytes48(c) for c in cs], [Bytes48(p) for p in ps], settings, backend
        )
    except BadArgs as e:
        outcome = str(e)
    return outcome, fetched[0].tolist()


def _jax(jsettings, blobs, cs, ps):
    try:
        return JKzg.verify_blob_kzg_proof_batch(
            [JBlob(b, bytes_per_blob=BPB) for b in blobs],
            [JBytes48(c) for c in cs],
            [JBytes48(p) for p in ps],
            jsettings,
            JaxBackend(),
        )
    except JBadArgs as e:
        return str(e)


@pytest.fixture
def calls(monkeypatch, stage1_memo):
    """Counts of the port's stage-1 and barycentric calls (one a chunk),
    stage 1 through the module's memo."""
    counts = {"stage1": 0, "bary": 0}
    real_stage1, real_bary = V.batch_points, V.bary_batch_from_bytes

    def stage1(comp):
        counts["stage1"] += 1
        key = comp.numpy().tobytes()
        if key not in stage1_memo:
            stage1_memo[key] = real_stage1(comp)
        return stage1_memo[key]

    def bary(ctx, blob_bytes, xs):
        counts["bary"] += 1
        return real_bary(ctx, blob_bytes, xs)

    monkeypatch.setattr(V, "batch_points", stage1)
    monkeypatch.setattr(V, "bary_batch_from_bytes", bary)
    return counts


@pytest.mark.parametrize("lane", ["valid", "swapped", "noncanonical", "malformed", "non_subgroup"])
@pytest.mark.parametrize("n", [5, 9])
def test_chunked_matches_jax_and_full_width(n, lane, setups, triples, chunked, calls, monkeypatch):
    """Each lane through the port's chunked branches: the JAX package's
    chunked branches give the same outcome, and the port's full-width path
    the same outcome and the same fetched words (flags and every y)."""
    settings, jsettings = setups
    blobs, cs, ps = _lane(triples, n, lane)
    got, words = _port(settings, blobs, cs, ps, TB.TorchBackend(device="cpu"))
    npad = 8 if n == 5 else 16
    assert calls == {"stage1": npad // WIDTH, "bary": npad // WIDTH}
    want = _jax(jsettings, blobs, cs, ps)
    expected = {"valid": True, "swapped": False}.get(lane)
    assert got == want
    assert expected is None or got is expected

    monkeypatch.setattr(TB, "BARY_CHUNK_BLOBS", npad)
    monkeypatch.setattr(TB, "STAGE1_CHUNK_BLOBS", npad)
    calls.update(stage1=0, bary=0)
    full, full_words = _port(settings, blobs, cs, ps, TB.TorchBackend(device="cpu"))
    assert calls == {"stage1": 1, "bary": 1}
    assert full == got
    assert full_words == words


def test_error_order_across_chunks(setups, triples, chunked, calls):
    """A malformed point in chunk 0 and a non-canonical blob in the last
    chunk: the point's decode error, in both packages."""
    settings, jsettings = setups
    blobs, cs, ps = (list(x) for x in triples)
    cs[0] = b"\x11" * 48
    blobs[8] = b"\xff" * 32 + blobs[8][32:]
    got, words = _port(settings, blobs, cs, ps, TB.TorchBackend(device="cpu"))
    assert calls == {"stage1": 8, "bary": 8}
    assert got == MSG_INVALID_COMPRESSED_G1
    assert words[0] == words[2] == 0
    assert isinstance(_jax(jsettings, blobs, cs, ps), str)


@pytest.mark.parametrize("n", [5, 9, 40])
def test_challenges_equal_the_preimage_hash(n, triples):
    """Every challenge, hashed in the pool's groups (inline below 8 blobs)
    and read back over ranges that cut the groups, equals the hash of the
    joined preimage."""
    blobs, cs, _ = triples
    blobs = [Blob(blobs[i % 9], bytes_per_blob=BPB) for i in range(n)]
    cs = [Bytes48(cs[i % 9]) for i in range(n)]
    want = [serde.hash_to_bls_field_sha(serde.challenge_preimage(MINIMAL, b, c)) for b, c in zip(blobs, cs)]
    ch = TB._Challenges(MINIMAL, blobs, cs)
    cuts = sorted({0, n, 1, 3, n // 2, min(17, n), n - 1})
    got = [z for lo, hi in zip(cuts, cuts[1:]) for z in ch.get(lo, hi)]
    assert got == want
    assert ch.get(n, n) == ch.get(n + 5, n + 5) == []
