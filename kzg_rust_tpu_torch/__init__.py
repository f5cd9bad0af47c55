"""kzg_rust_tpu_torch - the PyTorch/CUDA port of kzg_rust_tpu, an EIP-4844 KZG
polynomial-commitment framework.  Its device layer runs on an NVIDIA Hopper
card (hand-written CUDA kernels under ``csrc/``); its host layer is a copy of
the JAX package's.

Public surface mirrors the reference re-exports (reference: src/lib.rs:7-12):
the ``Kzg`` facade, the byte-wrapper types, ``KzgSettings``/``TrustedSetup``,
the error types, and the size constants - plus the preset objects the
reference README promises (mainnet / minimal).
"""

from .api import Kzg
from .errors import (
    BadArgs,
    InternalError,
    InvalidBytesLength,
    InvalidHexFormat,
    InvalidTrustedSetup,
    KzgError,
)
from .presets import (
    BYTES_PER_COMMITMENT,
    BYTES_PER_FIELD_ELEMENT,
    BYTES_PER_G1,
    BYTES_PER_G2,
    BYTES_PER_PROOF,
    MAINNET,
    MINIMAL,
    PRESETS,
    TRUSTED_SETUP_NUM_G2_POINTS,
    Preset,
)
from .settings import KzgSettings, TrustedSetup
from .types import Blob, Bytes32, Bytes48, KzgCommitment, KzgProof

__version__ = "0.1.0"

__all__ = [
    "Kzg",
    "KzgSettings",
    "TrustedSetup",
    "Blob",
    "Bytes32",
    "Bytes48",
    "KzgCommitment",
    "KzgProof",
    "KzgError",
    "BadArgs",
    "InternalError",
    "InvalidBytesLength",
    "InvalidHexFormat",
    "InvalidTrustedSetup",
    "Preset",
    "MAINNET",
    "MINIMAL",
    "PRESETS",
    "BYTES_PER_FIELD_ELEMENT",
    "BYTES_PER_COMMITMENT",
    "BYTES_PER_PROOF",
    "BYTES_PER_G1",
    "BYTES_PER_G2",
    "TRUSTED_SETUP_NUM_G2_POINTS",
]
