"""Byte <-> field-element conversions and Fiat-Shamir hashing (host side).

Mirrors reference: src/utils.rs:221-320 (serialization) and the two SHA-256
challenge constructions (reference: kzg.rs:298-339, utils.rs:426-474).
Sequential-by-nature pieces (hashing over raw input bytes) stay on host per
SURVEY.md section 7; everything is bit-exact to the reference layouts.
"""

from __future__ import annotations

import hashlib

from .. import hostcrypto
from ..errors import BadArgs
from ..golden.field import R
from ..presets import (
    FIAT_SHAMIR_PROTOCOL_DOMAIN,
    RANDOM_CHALLENGE_KZG_BATCH_DOMAIN,
    Preset,
)
from ..types import Bytes32, Bytes48
from ..messages import MSG_INVALID_BYTES32, MSG_NOT_IN_SUBGROUP


def bytes_from_uint64(n: int) -> bytes:
    """Big-endian u64 (reference: utils.rs:241)."""
    return int(n).to_bytes(8, "big")


def hash_to_bls_field(b: bytes) -> int:
    """BE bytes reduced mod r - no canonicality check (reference: utils.rs:250)."""
    return int.from_bytes(b, "big") % R


def bytes_to_bls_field(b: bytes) -> int:
    """32 BE bytes -> Fr, rejecting values >= r (reference: utils.rs:262-275;
    the 32-byte length is enforced by the reference's Bytes32 type and must
    hold for raw-bytes callers too)."""
    if len(b) != 32:
        raise BadArgs("bytes_to_bls_field Invalid Bytes32 length")
    v = int.from_bytes(b, "big")
    if v >= R:
        raise BadArgs(MSG_INVALID_BYTES32)
    return v


def bytes_from_bls_field(v: int) -> Bytes32:
    """Fr -> 32 BE bytes (reference: utils.rs:230)."""
    return Bytes32((v % R).to_bytes(32, "big"))


def bytes_from_g1(p) -> Bytes48:
    """Compress a G1 point (reference: utils.rs:221)."""
    return Bytes48(hostcrypto.g1_compress(p))


def validate_kzg_g1(b: bytes):
    """Uncompress + accept infinity + require subgroup (reference: utils.rs:282-310)."""
    p = hostcrypto.g1_uncompress(bytes(b))  # on-curve checked
    if p is None:
        return None  # the point at infinity is accepted
    if not hostcrypto.g1_in_subgroup(p):
        raise BadArgs(MSG_NOT_IN_SUBGROUP)
    return p


def bytes_to_kzg_commitment(b: bytes):
    return validate_kzg_g1(b)


def bytes_to_kzg_proof(b: bytes):
    return validate_kzg_g1(b)


def compute_powers(x: int, n: int) -> list[int]:
    """[x^0=1, x^1, ..., x^(n-1)] (reference: utils.rs:413-423)."""
    out = []
    acc = 1
    for _ in range(n):
        out.append(acc)
        acc = (acc * x) % R
    return out


def compute_challenge(preset: Preset, blob: bytes, commitment_bytes: bytes) -> int:
    """Fiat-Shamir evaluation challenge (reference: kzg.rs:298-339).

    Preimage: domain || u64(0) || u64(n) (a 16-byte BE degree field) ||
    blob || commitment. The commitment bytes are validated as a G1 point
    *before* hashing (reference: kzg.rs:320-323).
    """
    bytes_to_kzg_commitment(commitment_bytes)  # raises on invalid commitment
    return challenge_hash(preset, blob, commitment_bytes)


def challenge_preimage(preset: Preset, blob: bytes, commitment_bytes: bytes) -> bytes:
    """The compute_challenge SHA-256 preimage (reference: kzg.rs:298-339;
    16-byte degree field = two u64s)."""
    preimage = (
        FIAT_SHAMIR_PROTOCOL_DOMAIN
        + bytes_from_uint64(0)
        + bytes_from_uint64(preset.field_elements_per_blob)
        + bytes(blob)
        + bytes(commitment_bytes)
    )
    if len(preimage) != preset.challenge_input_size:
        raise BadArgs("compute_challenge: invalid preimage length")
    return preimage


def hash_to_bls_field_sha(preimage: bytes) -> int:
    """SHA-256 then reduce mod r (reference: hash_to_bls_field,
    utils.rs:250-258).  GIL-friendly: hashlib releases the GIL for large
    inputs, so batch callers can fan these out over threads."""
    return hash_to_bls_field(hashlib.sha256(preimage).digest())


def challenge_hash(preset: Preset, blob: bytes, commitment_bytes: bytes) -> int:
    """The challenge hash alone, for callers that already validated the
    commitment (the batched device pipeline validates all points in one
    kernel before hashing)."""
    return hash_to_bls_field_sha(challenge_preimage(preset, blob, commitment_bytes))


def compute_r_powers(
    preset: Preset,
    commitments_bytes: list[bytes],
    zs: list[int],
    ys: list[int],
    proofs_bytes: list[bytes],
) -> list[int]:
    """RLC challenge powers for batch verification (reference: utils.rs:426-474).

    Preimage: domain || u64(n_blob_elems) || u64(n) (8-byte fields here, vs
    the 16-byte degree field in compute_challenge) || per-blob
    (commitment || z || y || proof).
    """
    n = len(commitments_bytes)
    preimage = bytearray()
    preimage += RANDOM_CHALLENGE_KZG_BATCH_DOMAIN
    preimage += bytes_from_uint64(preset.field_elements_per_blob)
    preimage += bytes_from_uint64(n)
    for i in range(n):
        preimage += bytes(commitments_bytes[i])
        preimage += bytes_from_bls_field(zs[i])
        preimage += bytes_from_bls_field(ys[i])
        preimage += bytes(proofs_bytes[i])
    r = hash_to_bls_field(hashlib.sha256(bytes(preimage)).digest())
    return compute_powers(r, n)
