"""The timed path broken underneath the harness, each fault a cell can
have (one card: there is no exchange between chips to leave out), and
``correct`` must come out false: an answer altered where it is produced,
half of the batch left out, and a step that returns its state unchanged."""

import time

import pytest

from kzg_rust_tpu_torch import KzgError
from kzg_rust_tpu_torch.api import Kzg
from kzgbench import generator, harness, pool, workers

SEED = 3_000_000_003


def run(root, cell):
    return harness.run(cell, SEED, 0.5, False, time.perf_counter(), device="cpu", root=root, reference_workers=2)


def altered_verdict(real):
    """The verdict negated, and a refusal turned into True."""

    def broken(blobs, commitments, proofs, settings, backend=None):
        try:
            return not real(blobs, commitments, proofs, settings, backend)
        except KzgError:
            return True

    return broken


def half_the_lanes(real):
    def broken(blobs, commitments, proofs, settings, backend=None):
        h = len(blobs) // 2
        return real(blobs[:h], commitments[:h], proofs[:h], settings, backend)

    return broken


def stale(real):
    seen = []

    def broken(*args):
        if not seen:
            seen.append(real(*args))
        return seen[0]

    return broken


def fault_in_second_half_seed(root) -> int:
    """A seed whose first window call carries its fault in lanes 2-3 (the
    half that ``half_the_lanes`` leaves out)."""
    wl, cfg, mix = harness.load_cell("min.verify", root)
    path = pool.path_for(harness.CACHE + "/pool", cfg, f"{root}/{cfg['trusted_setup']}", mix["pool_seed"], mix["pool_size"])
    triples = pool.load_or_make(path, 4, mix["pool_seed"], mix["pool_size"], lambda: workers.executor(f"{root}/{cfg['trusted_setup']}", 4, None, 2))
    for seed in range(SEED, SEED + 100):
        t = generator.traffic(mix, cfg, seed, triples, 0)
        if t.call(0).fault["lane"] >= 2:
            return seed
    raise AssertionError("no seed found")


@pytest.mark.parametrize("fault", [altered_verdict, half_the_lanes, stale])
def test_broken_verification_is_not_correct(minimal_root, monkeypatch, fault):
    root = minimal_root({"fault_every": 1})
    seed = fault_in_second_half_seed(root) if fault is half_the_lanes else SEED
    monkeypatch.setattr(Kzg, "verify_blob_kzg_proof_batch", staticmethod(fault(Kzg.verify_blob_kzg_proof_batch)))
    r = harness.run("min.verify", seed, 0.5, False, time.perf_counter(), device="cpu", root=root, reference_workers=2)
    assert r["correct"] is False, r["checks"]


def altered_commitment(real):
    def broken(blob, settings, backend=None):
        c = bytes(real(blob, settings, backend))
        return c[:-1] + bytes([c[-1] ^ 1])

    return broken


def half_the_elements(real):
    def broken(blob, settings, backend=None):
        b = bytes(blob)
        return real(b[: len(b) // 2] + bytes(len(b) - len(b) // 2), settings, backend)

    return broken


@pytest.mark.parametrize("fault", [altered_commitment, half_the_elements, stale])
def test_broken_prover_is_not_correct(minimal_root, monkeypatch, fault):
    root = minimal_root()
    monkeypatch.setattr(Kzg, "blob_to_kzg_commitment", staticmethod(fault(Kzg.blob_to_kzg_commitment)))
    r = run(root, "min.tx")
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["verify_rejected_batches"]["value"] > 0, r["checks"]
