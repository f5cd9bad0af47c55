"""The plain reference against the mainnet vectors of the two functions a
blob poster calls, blob_to_kzg_commitment and compute_blob_kzg_proof (a
few seconds each: the reference's MSM is plain Python)."""

import os

import pytest

from kzgbench.reference import kzg

from . import vectors

KINDS = ("blob_to_kzg_commitment", "compute_blob_kzg_proof")
CASES = [(k, p) for k in KINDS for p in vectors.cases("vectors", k)]
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    return kzg.Setup(os.path.join(BENCH, "configs", "trusted_setup.txt"), 4096)


@pytest.mark.parametrize("kind,path", CASES, ids=[os.path.basename(os.path.dirname(p)) for _, p in CASES])
def test_reference_matches_mainnet_prover_vector(setup, kind, path):
    fields, want = vectors.read_vector(path)
    assert vectors.run(setup, kind, fields) == want


def test_every_prover_vector_is_read():
    assert len(CASES) == 10 + 14
