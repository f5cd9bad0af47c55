"""Error types for the TPU-native KZG library.

Mirrors the reference error enum (reference: src/kzg.rs:10-22) as a Python
exception hierarchy. The reference returns ``Result<_, Error>``; we raise.
Every error raised by the public API is a subclass of :class:`KzgError`, so
callers (and the conformance harness) can catch one type.
"""

from __future__ import annotations


class KzgError(Exception):
    """Base class for all KZG library errors."""


class BadArgs(KzgError):
    """The supplied data is invalid in some way (reference: kzg.rs:12)."""


class InternalError(KzgError):
    """Internal error - this should never happen (reference: kzg.rs:14)."""


class InvalidBytesLength(KzgError):
    """A fixed-size byte container got the wrong length (reference: kzg.rs:16)."""


class InvalidHexFormat(KzgError):
    """Hex string could not be decoded (reference: kzg.rs:18)."""


class InvalidTrustedSetup(KzgError):
    """The trusted setup file/data is malformed (reference: kzg.rs:20)."""
