"""The reference's worker processes: the pool's triples, and the calls and
blobs a run's check recomputes, each in a process of its own (spawned, so
that no state of the program under test is inherited).

:func:`executor` starts them; each holds the setup, the pool and a
:class:`.reference.kzg.Memo` for the tasks it runs.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from . import generator, pool
from .reference import kzg

_STATE: dict = {}


def executor(setup_path: str, fe: int, pool_path: str | None, workers: int | None = None) -> ProcessPoolExecutor:
    workers = workers or min(8, os.cpu_count() or 1)
    return ProcessPoolExecutor(
        workers,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_init,
        initargs=(setup_path, fe, pool_path),
    )


def _init(setup_path: str, fe: int, pool_path: str | None) -> None:
    _STATE["setup"] = kzg.Setup(setup_path, fe)
    _STATE["pool"] = pool.read(pool_path, fe) if pool_path else None
    _STATE["memo"] = kzg.Memo()


def outcome(fn, *args):
    """True or False, or the kind of the reference's error."""
    try:
        return bool(fn(*args))
    except kzg.RefError as e:
        return e.kind


def make_triple(pool_seed: int, i: int) -> tuple[bytes, bytes, bytes]:
    """Pool triple i: a random blob of the pool seed, its commitment and
    its proof, made by the reference prover."""
    setup = _STATE["setup"]
    blob = generator.random_blob(generator.rng(pool_seed, i), setup.fe)
    commitment = kzg.blob_to_kzg_commitment(setup, blob)
    return blob, commitment, kzg.compute_blob_kzg_proof(setup, blob, commitment)


def lanes(desc: dict) -> tuple[list, list, list]:
    """A verification call's blobs, commitments and proofs from its pool
    indices and its fault."""
    triples = [_STATE["pool"][i] for i in desc["lanes"]]
    cols = {"blob": [t[0] for t in triples], "commitment": [t[1] for t in triples], "proof": [t[2] for t in triples]}
    f = desc["fault"]
    if f is not None:
        cols[f["field"]][f["lane"]] = f["bytes"]
    return cols["blob"], cols["commitment"], cols["proof"]


def verify(desc: dict, subgroup_check: bool = True):
    """The reference's answer to one verification call (``subgroup_check``
    false for the control)."""
    blobs, comms, proofs = lanes(desc)
    return outcome(kzg.verify_blob_kzg_proof_batch, _STATE["setup"], blobs, comms, proofs, _STATE["memo"], subgroup_check)


def verify_outputs(triples: list) -> object:
    """The reference's batch verification of (blob, commitment, proof)
    triples that the prover under test made."""
    blobs, comms, proofs = ([t[i] for t in triples] for i in range(3))
    return outcome(kzg.verify_blob_kzg_proof_batch, _STATE["setup"], blobs, comms, proofs)


def prove(blob: bytes, bind_commitment: bool = True) -> tuple[bytes, bytes]:
    """The reference's commitment and proof of one blob
    (``bind_commitment`` false for the control)."""
    setup = _STATE["setup"]
    commitment = kzg.blob_to_kzg_commitment(setup, blob)
    return commitment, kzg.compute_blob_kzg_proof(setup, blob, commitment, bind_commitment)
