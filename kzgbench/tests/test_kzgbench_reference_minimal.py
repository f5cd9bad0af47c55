"""The plain reference against every minimal-preset c-kzg vector."""

import os

import pytest

from kzgbench.reference import kzg

from . import vectors

KINDS = ("blob_to_kzg_commitment", "compute_blob_kzg_proof", "compute_kzg_proof", "verify_kzg_proof", "verify_blob_kzg_proof", "verify_blob_kzg_proof_batch")
CASES = [(k, p) for k in KINDS for p in vectors.cases("vectors_minimal", k)]


@pytest.fixture(scope="module")
def setup():
    return kzg.Setup(os.path.join(os.path.dirname(__file__), "data", "trusted_setup_minimal.txt"), 4)


@pytest.mark.parametrize("kind,path", CASES, ids=[os.path.basename(os.path.dirname(p)) for _, p in CASES])
def test_reference_matches_minimal_vector(setup, kind, path):
    fields, want = vectors.read_vector(path)
    assert vectors.run(setup, kind, fields) == want


def test_every_minimal_kind_has_vectors():
    assert {k for k, _ in CASES} == set(KINDS) and len(CASES) == 28
