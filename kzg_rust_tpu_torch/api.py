"""Public API facade.

Mirrors the reference's ``Kzg`` static-method surface (reference:
src/kzg.rs:983-1079, re-exported at src/lib.rs:7-12): the two trusted-setup
loaders plus the six EIP-4844 operations. Methods take an explicit
``KzgSettings`` like the reference; ``backend`` selects the compute path
("torch" = CUDA tensor path, "golden" = pure-Python oracle) or is a backend
object such as ``TorchBackend(device="cpu")``.
"""

from __future__ import annotations

import os

from . import protocol
from .backends import get_backend
from .presets import MAINNET, Preset
from .settings import (
    KzgSettings,
    TrustedSetup,
    load_trusted_setup_from_arrays,
    load_trusted_setup_file,
)
from .types import Blob, Bytes32, Bytes48, KzgCommitment, KzgProof


def default_backend_name() -> str:
    """``KZG_TORCH_BACKEND`` if set, else "torch": the default runs on the
    card and raises where CUDA is absent."""
    return os.environ.get("KZG_TORCH_BACKEND") or "torch"


def _resolve(backend):
    if backend is None:
        return get_backend(default_backend_name())
    if isinstance(backend, str):
        return get_backend(backend)
    return backend


class Kzg:
    """The eight spec functions (reference: kzg.rs:983-1079)."""

    @staticmethod
    def load_trusted_setup_file(path, preset: Preset = MAINNET) -> KzgSettings:
        # reference: kzg.rs:995
        return load_trusted_setup_file(path, preset)

    @staticmethod
    def load_trusted_setup(trusted_setup: TrustedSetup, preset: Preset | None = None) -> KzgSettings:
        # reference: kzg.rs:1005
        preset = preset or trusted_setup.preset
        return load_trusted_setup_from_arrays(
            trusted_setup.g1_points(), trusted_setup.g2_points(), preset
        )

    @staticmethod
    def blob_to_kzg_commitment(
        blob: Blob, settings: KzgSettings, backend=None
    ) -> KzgCommitment:
        # reference: kzg.rs:1013
        return protocol.blob_to_kzg_commitment(settings, blob, _resolve(backend))

    @staticmethod
    def compute_kzg_proof(
        blob: Blob, z: Bytes32, settings: KzgSettings, backend=None
    ) -> tuple[KzgProof, Bytes32]:
        # reference: kzg.rs:1021
        return protocol.compute_kzg_proof(settings, blob, z, _resolve(backend))

    @staticmethod
    def compute_blob_kzg_proof(
        blob: Blob, commitment: Bytes48, settings: KzgSettings, backend=None
    ) -> KzgProof:
        # reference: kzg.rs:1030
        return protocol.compute_blob_kzg_proof(settings, blob, commitment, _resolve(backend))

    @staticmethod
    def verify_kzg_proof(
        commitment: Bytes48,
        z: Bytes32,
        y: Bytes32,
        proof: Bytes48,
        settings: KzgSettings,
        backend=None,
    ) -> bool:
        # reference: kzg.rs:1039
        return protocol.verify_kzg_proof(settings, commitment, z, y, proof, _resolve(backend))

    @staticmethod
    def verify_blob_kzg_proof(
        blob: Blob,
        commitment: Bytes48,
        proof: Bytes48,
        settings: KzgSettings,
        backend=None,
    ) -> bool:
        # reference: kzg.rs:1050
        return protocol.verify_blob_kzg_proof(settings, blob, commitment, proof, _resolve(backend))

    @staticmethod
    def verify_blob_kzg_proof_batch(
        blobs: list[Blob],
        commitments: list[Bytes48],
        proofs: list[Bytes48],
        settings: KzgSettings,
        backend=None,
    ) -> bool:
        # reference: kzg.rs:1066
        return protocol.verify_blob_kzg_proof_batch(
            settings, blobs, commitments, proofs, _resolve(backend)
        )
