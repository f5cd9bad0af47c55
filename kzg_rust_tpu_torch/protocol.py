"""The EIP-4844 protocol layer, backend-agnostic.

Mirrors reference: src/kzg.rs:282-693 - blob->polynomial conversion,
Fiat-Shamir challenges, barycentric evaluation dispatch, quotient/proof
construction, single + blob + batch verification. All heavy math is routed
through a backend (golden or jax); everything here is validation, hashing,
special-case handling, and byte plumbing - bit-exact to the reference.
"""

from __future__ import annotations

from .errors import BadArgs
from .golden import curve
from .settings import KzgSettings
from .types import Blob, Bytes32, Bytes48, KzgCommitment, KzgProof
from .utils import bls_serde as serde
from .messages import MSG_BLOB_LENGTH


def blob_to_polynomial(settings: KzgSettings, blob: bytes) -> list[int]:
    """Split the blob into 32-byte BE chunks, each validated < r
    (reference: kzg.rs:282-291; the length check lives in the reference's
    Blob type, kzg.rs:154-178, and must hold for raw-bytes callers too)."""
    if len(blob) != settings.preset.bytes_per_blob:
        raise BadArgs(MSG_BLOB_LENGTH)
    n = settings.preset.field_elements_per_blob
    evals = []
    for i in range(n):
        chunk = blob[i * 32 : (i + 1) * 32]
        evals.append(serde.bytes_to_bls_field(chunk))
    return evals


def evaluate_polynomial_in_evaluation_form(
    settings: KzgSettings, evals: list[int], x: int, backend
) -> int:
    """Barycentric evaluation with the in-domain short-circuit
    (reference: kzg.rs:346-389)."""
    roots = settings.roots_of_unity
    for i in range(settings.preset.field_elements_per_blob):
        if x == roots[i]:
            return evals[i]
    return backend.barycentric_eval(settings, evals, x)


def blob_to_kzg_commitment(settings: KzgSettings, blob: bytes, backend) -> KzgCommitment:
    """reference: kzg.rs:396-406."""
    pipe = getattr(backend, "blob_to_commitment_pipeline", None)
    if pipe is not None:
        commitment = pipe(settings, blob)
        if commitment is not NotImplemented:
            return KzgCommitment(serde.bytes_from_g1(commitment))
    evals = blob_to_polynomial(settings, blob)
    commitment = backend.msm_g1_lagrange(settings, evals)
    return KzgCommitment(serde.bytes_from_g1(commitment))


def compute_kzg_proof_impl(
    settings: KzgSettings, evals: list[int], z: int, backend
) -> tuple[KzgProof, int]:
    """Quotient polynomial + MSM (reference: kzg.rs:461-528)."""
    y = evaluate_polynomial_in_evaluation_form(settings, evals, z, backend)
    roots = settings.roots_of_unity
    m = None
    for i in range(settings.preset.field_elements_per_blob):
        if z == roots[i]:
            m = i
            break
    if m is None:
        q = backend.quotient_out_of_domain(settings, evals, z, y)
    else:
        q = backend.quotient_in_domain(settings, evals, z, y, m)
    out_g1 = backend.msm_g1_lagrange(settings, q)
    return KzgProof(serde.bytes_from_g1(out_g1)), y


def compute_kzg_proof(
    settings: KzgSettings, blob: bytes, z_bytes: bytes, backend
) -> tuple[KzgProof, Bytes32]:
    """reference: kzg.rs:446-457. Returns (proof, y)."""
    pipe = getattr(backend, "compute_kzg_proof_pipeline", None)
    if pipe is not None:
        z = serde.bytes_to_bls_field(z_bytes)
        out = pipe(settings, blob, z)
        if out is not NotImplemented:
            proof_pt, y = out
            return KzgProof(serde.bytes_from_g1(proof_pt)), serde.bytes_from_bls_field(y)
    evals = blob_to_polynomial(settings, blob)
    z = serde.bytes_to_bls_field(z_bytes)
    proof, y = compute_kzg_proof_impl(settings, evals, z, backend)
    return proof, serde.bytes_from_bls_field(y)


def compute_blob_kzg_proof(
    settings: KzgSettings, blob: bytes, commitment_bytes: bytes, backend
) -> KzgProof:
    """reference: kzg.rs:533-544."""
    fused = getattr(backend, "compute_blob_proof_pipeline", None)
    if fused is not None:
        out = fused(settings, blob, commitment_bytes)
        if out is not NotImplemented:
            return KzgProof(serde.bytes_from_g1(out))
    # compute_challenge validates the commitment before hashing.
    challenge = serde.compute_challenge(settings.preset, blob, commitment_bytes)
    pipe = getattr(backend, "compute_kzg_proof_pipeline", None)
    if pipe is not None:
        out = pipe(settings, blob, challenge)
        if out is not NotImplemented:
            return KzgProof(serde.bytes_from_g1(out[0]))
    evals = blob_to_polynomial(settings, blob)
    proof, _y = compute_kzg_proof_impl(settings, evals, challenge, backend)
    return proof


def verify_kzg_proof_impl(
    settings: KzgSettings, commitment, z: int, y: int, proof, backend
) -> bool:
    """e(C - [y]G1, G2) == e(proof, [s - z]G2) (reference: kzg.rs:409-426)."""
    x_g2 = backend.g2_mul(curve.G2_GENERATOR, z)
    x_minus_z = backend.g2_sub(settings.g2_values[1], x_g2)
    y_g1 = backend.g1_mul(curve.G1_GENERATOR, y)
    p_minus_y = backend.g1_sub(commitment, y_g1)
    return backend.pairings_verify(p_minus_y, curve.G2_GENERATOR, proof, x_minus_z)


def verify_kzg_proof(
    settings: KzgSettings,
    commitment_bytes: bytes,
    z_bytes: bytes,
    y_bytes: bytes,
    proof_bytes: bytes,
    backend,
) -> bool:
    """reference: kzg.rs:429-443."""
    pipe = getattr(backend, "verify_kzg_proof_pipeline", None)
    if pipe is not None:
        out = pipe(settings, commitment_bytes, z_bytes, y_bytes, proof_bytes)
        if out is not NotImplemented:
            return out
    commitment = serde.bytes_to_kzg_commitment(commitment_bytes)
    z = serde.bytes_to_bls_field(z_bytes)
    y = serde.bytes_to_bls_field(y_bytes)
    proof = serde.bytes_to_kzg_proof(proof_bytes)
    return verify_kzg_proof_impl(settings, commitment, z, y, proof, backend)


def verify_blob_kzg_proof(
    settings: KzgSettings, blob: bytes, commitment_bytes: bytes, proof_bytes: bytes, backend
) -> bool:
    """reference: kzg.rs:547-569."""
    pipe = getattr(backend, "verify_blob_pipeline", None)
    if pipe is not None:
        out = pipe(settings, blob, commitment_bytes, proof_bytes)
        if out is not NotImplemented:
            return out
    commitment = serde.bytes_to_kzg_commitment(commitment_bytes)
    evals = blob_to_polynomial(settings, blob)
    # challenge_hash, not compute_challenge: the commitment was validated
    # on the line above (same validate-before-hash order as kzg.rs:320-323).
    challenge = serde.challenge_hash(settings.preset, blob, commitment_bytes)
    y = evaluate_polynomial_in_evaluation_form(settings, evals, challenge, backend)
    proof = serde.bytes_to_kzg_proof(proof_bytes)
    return verify_kzg_proof_impl(settings, commitment, challenge, y, proof, backend)


def verify_kzg_proof_batch(
    settings: KzgSettings,
    commitments,
    zs,
    ys,
    proofs,
    backend,
    commitment_bytes=None,
    proof_bytes=None,
) -> bool:
    """RLC batch check (reference: kzg.rs:579-627):
    e(sum r^i proof_i, [s]G2) ==
    e(sum r^i (C_i - [y_i]G1) + sum (r^i z_i) proof_i, G2).
    Uses naive lincombs by design (reference: utils.rs:349-356).  Callers
    holding the original compressed bytes pass them through - the RLC hash
    preimage is built from input bytes (reference: utils.rs:426-474), so
    this also avoids 2n recompressions."""
    n = len(commitments)
    if commitment_bytes is None:
        commitment_bytes = [serde.bytes_from_g1(c) for c in commitments]
    if proof_bytes is None:
        proof_bytes = [serde.bytes_from_g1(p) for p in proofs]
    r_powers = serde.compute_r_powers(
        settings.preset, commitment_bytes, zs, ys, proof_bytes
    )
    proof_lincomb = backend.g1_lincomb(proofs, r_powers)

    c_minus_y = []
    r_times_z = []
    for i in range(n):
        y_g1 = backend.g1_mul(curve.G1_GENERATOR, ys[i])
        c_minus_y.append(backend.g1_sub(commitments[i], y_g1))
        r_times_z.append((r_powers[i] * zs[i]) % curve.R)

    proof_z_lincomb = backend.g1_lincomb(proofs, r_times_z)
    c_minus_y_lincomb = backend.g1_lincomb(c_minus_y, r_powers)
    rhs_g1 = backend.g1_add(c_minus_y_lincomb, proof_z_lincomb)

    return backend.pairings_verify(
        proof_lincomb, settings.g2_values[1], rhs_g1, curve.G2_GENERATOR
    )


def verify_blob_kzg_proof_batch(
    settings: KzgSettings,
    blobs: list[bytes],
    commitments_bytes: list[bytes],
    proofs_bytes: list[bytes],
    backend,
) -> bool:
    """reference: kzg.rs:637-693."""
    if not (len(blobs) == len(commitments_bytes) == len(proofs_bytes)):
        raise BadArgs("verify_blob_kzg_proof_batch: different lengths")
    n = len(blobs)
    if n == 0:
        return True
    if n == 1:
        return verify_blob_kzg_proof(
            settings, blobs[0], commitments_bytes[0], proofs_bytes[0], backend
        )

    # Backends may own the whole batch (the jax backend fuses the per-blob
    # loop below plus the lincombs of verify_kzg_proof_batch into batched
    # device programs); semantics are identical.
    pipeline = getattr(backend, "verify_blob_batch_pipeline", None)
    if pipeline is not None:
        return pipeline(settings, blobs, commitments_bytes, proofs_bytes)

    commitments, zs, ys, proofs = [], [], [], []
    for i in range(n):
        commitments.append(serde.bytes_to_kzg_commitment(commitments_bytes[i]))
        evals = blob_to_polynomial(settings, blobs[i])
        # commitment validated just above; hash without re-validating
        challenge = serde.challenge_hash(
            settings.preset, blobs[i], commitments_bytes[i]
        )
        zs.append(challenge)
        ys.append(
            evaluate_polynomial_in_evaluation_form(settings, evals, challenge, backend)
        )
        proofs.append(serde.bytes_to_kzg_proof(proofs_bytes[i]))

    return verify_kzg_proof_batch(
        settings,
        commitments,
        zs,
        ys,
        proofs,
        backend,
        commitment_bytes=[bytes(b) for b in commitments_bytes],
        proof_bytes=[bytes(b) for b in proofs_bytes],
    )
