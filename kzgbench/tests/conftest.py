"""Tests of the benchmark harness.  Most run on the CPU at the minimal
preset with ``TorchBackend(device="cpu")``; the tests that need a card
carry the ``card`` marker and its fixture, which skips them where CUDA is
absent (decided when the test runs, never at import)."""

import json
import os
import shutil

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(BENCH, "tests", "data")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)


def _minimal_root(root, verify_mix=None, tx_mix=None) -> str:
    root = str(root)
    os.makedirs(os.path.join(root, "configs"), exist_ok=True)
    shutil.copy(os.path.join(DATA, "trusted_setup_minimal.txt"), os.path.join(root, "configs"))
    for kind in ("node", "poster"):
        with open(os.path.join(BENCH, "configs", f"mainnet-{kind}.json")) as fh:
            cfg = json.load(fh)
        cfg.update(name=f"minimal-{kind}", preset="minimal", FIELD_ELEMENTS_PER_BLOB=4, BYTES_PER_BLOB=128, trusted_setup="configs/trusted_setup_minimal.txt")
        _write(os.path.join(root, "configs", f"minimal-{kind}.json"), cfg)
    verify = {
        "api": "verify_blob_kzg_proof_batch", "blobs_per_call": 4, "fault_every": 2,
        "fault_kinds": ["wrong_proof", "blob_byte", "non_canonical", "bad_encoding", "off_subgroup"],
        "pool_size": 6, "pool_seed": 4844, "ring_llc_multiple": 0, "prebuilt_calls": 8,
        "warmup_calls": 1, "trace_calls": 1, "reference_valid_calls": "all", "end_to_end": ["verify_call_p95_ms"],
    }
    verify.update(verify_mix or {})
    tx = {"api": "blob_tx", "blobs_per_call": 2, "ring_llc_multiple": 0, "warmup_calls": 1, "trace_calls": 1, "reference_blobs": 4, "reference_verify_blobs": 4, "reference_verify_batch": 2, "end_to_end": ["prove_blobs_per_s", "prove_tx_p95_ms"]}
    tx.update(tx_mix or {})
    _write(os.path.join(root, "traffic", "min-verify.json"), verify)
    _write(os.path.join(root, "traffic", "min-tx.json"), tx)
    _write(os.path.join(root, "workloads", "min.verify.json"), {"config": "minimal-node", "traffic": "min-verify", "chips": 1})
    _write(os.path.join(root, "workloads", "min.tx.json"), {"config": "minimal-poster", "traffic": "min-tx", "chips": 1})
    return root


@pytest.fixture
def minimal_root(tmp_path):
    """A factory of throwaway benchmark roots at the minimal preset: the
    cells ``min.verify`` and ``min.tx`` over the minimal ceremony setup,
    their mixes updated by the arguments."""
    count = iter(range(1000))
    return lambda verify_mix=None, tx_mix=None: _minimal_root(tmp_path / f"root{next(count)}", verify_mix, tx_mix)
