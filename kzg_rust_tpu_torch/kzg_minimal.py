"""Minimal-preset namespace: ``FIELD_ELEMENTS_PER_BLOB = 4``.

Drop-in analog of the reference's promised ``kzg_minimal`` module
(reference: README.md:8-9): ``Kzg`` loaders default to the minimal
consensus-spec preset and ``Blob`` validates minimal length.
"""

from ._preset_module import build
from .errors import (  # noqa: F401
    BadArgs,
    InternalError,
    InvalidBytesLength,
    InvalidHexFormat,
    InvalidTrustedSetup,
    KzgError,
)
from .presets import MINIMAL as PRESET
from .settings import KzgSettings, TrustedSetup  # noqa: F401
from .types import Bytes32, Bytes48, KzgCommitment, KzgProof  # noqa: F401

Kzg, Blob = build(PRESET)

FIELD_ELEMENTS_PER_BLOB = PRESET.field_elements_per_blob
BYTES_PER_BLOB = PRESET.bytes_per_blob

__all__ = [
    "Kzg",
    "Blob",
    "Bytes32",
    "Bytes48",
    "KzgCommitment",
    "KzgProof",
    "KzgSettings",
    "TrustedSetup",
    "KzgError",
    "BadArgs",
    "InternalError",
    "InvalidBytesLength",
    "InvalidHexFormat",
    "InvalidTrustedSetup",
    "PRESET",
    "FIELD_ELEMENTS_PER_BLOB",
    "BYTES_PER_BLOB",
]
