"""The plain reference against the mainnet verification vectors of
c-kzg-4844 (every case of the three verification functions)."""

import os

import pytest

from kzgbench.reference import kzg

from . import vectors

KINDS = ("verify_blob_kzg_proof_batch", "verify_blob_kzg_proof", "verify_kzg_proof")
CASES = [(k, p) for k in KINDS for p in vectors.cases("vectors", k)]
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    return kzg.Setup(os.path.join(BENCH, "configs", "trusted_setup.txt"), 4096)


@pytest.mark.parametrize("kind,path", CASES, ids=[os.path.basename(os.path.dirname(p)) for _, p in CASES])
def test_reference_matches_mainnet_vector(setup, kind, path):
    fields, want = vectors.read_vector(path)
    assert vectors.run(setup, kind, fields) == want


def test_every_verification_vector_is_read():
    assert len(CASES) == 22 + 24 + 92
