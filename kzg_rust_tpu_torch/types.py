"""Fixed-size validated byte containers.

Mirrors the reference wrapper types (reference: src/kzg.rs:101-279):
``Bytes32``, ``Bytes48``, ``Blob``, ``KzgCommitment``, ``KzgProof`` - each a
thin validated wrapper over ``bytes`` with hex parsing. ``Blob`` is
preset-dependent, so its expected length is supplied by the owning settings
(the reference hard-codes 4096*32; we parameterize per SURVEY.md section 0).
"""

from __future__ import annotations

from .errors import InvalidBytesLength, InvalidHexFormat
from .presets import MAINNET


def hex_to_bytes(hex_str: str) -> bytes:
    """Decode hex with optional 0x prefix (reference: kzg.rs:82-86)."""
    if hex_str.startswith("0x"):
        hex_str = hex_str[2:]
    try:
        return bytes.fromhex(hex_str)
    except ValueError as e:
        raise InvalidHexFormat(f"Failed to decode hex: {e}") from None


class _FixedBytes(bytes):
    SIZE: int = 0

    def __new__(cls, data: bytes = b""):
        if data == b"":
            data = bytes(cls.SIZE)
        if len(data) != cls.SIZE:
            raise InvalidBytesLength(
                f"Invalid byte length. Expected {cls.SIZE} got {len(data)}"
            )
        return super().__new__(cls, data)

    @classmethod
    def from_bytes(cls, data: bytes):
        return cls(bytes(data))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(hex_to_bytes(hex_str))


class Bytes32(_FixedBytes):
    """32 validated bytes (reference: kzg.rs:101-122)."""

    SIZE = 32


class Bytes48(_FixedBytes):
    """48 validated bytes (reference: kzg.rs:124-152)."""

    SIZE = 48


class KzgCommitment(Bytes48):
    """A compressed G1 commitment (reference: kzg.rs:180-191)."""


class KzgProof(Bytes48):
    """A compressed G1 opening proof (reference: kzg.rs:193-204)."""


class Blob(bytes):
    """A blob: FIELD_ELEMENTS_PER_BLOB 32-byte field elements.

    (reference: kzg.rs:154-178; length parameterized by preset here.)
    """

    def __new__(cls, data: bytes, *, bytes_per_blob: int = MAINNET.bytes_per_blob):
        if len(data) != bytes_per_blob:
            raise InvalidBytesLength(
                f"Invalid byte length. Expected {bytes_per_blob} got {len(data)}"
            )
        return super().__new__(cls, data)

    @classmethod
    def from_bytes(cls, data: bytes, *, bytes_per_blob: int = MAINNET.bytes_per_blob):
        return cls(bytes(data), bytes_per_blob=bytes_per_blob)

    @classmethod
    def from_hex(cls, hex_str: str, *, bytes_per_blob: int = MAINNET.bytes_per_blob):
        return cls(hex_to_bytes(hex_str), bytes_per_blob=bytes_per_blob)
