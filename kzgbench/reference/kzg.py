"""The plain EIP-4844 reference that decides ``correct``.

The functions of consensus-specs ``deneb/polynomial-commitments.md`` as
c-kzg-4844 implements them, in Python integers over the frozen field,
curve and pairing modules beside this file.  Nothing here imports the
program under test: the trusted setup is parsed from its text file, the
roots of unity are computed, and every point is decoded and checked here.

Errors are :class:`RefError` with one of the kinds of :data:`ERROR_KINDS`,
the classes of input that the specs refuse (``blob_to_polynomial``,
``validate_kzg_g1``): the harness compares verdicts and error kinds.

Two shortcuts keep a check inside a run's time, neither of which changes a
result: :class:`Memo` keeps what one input always gives (a point's decoding
and subgroup check, a blob's evaluation at its challenge) by the input's
bytes, and the random linear combination of a batch is summed by distinct
point (the same group element as the spec's lincombs, since the
coefficients of equal points add).
"""

from __future__ import annotations

import hashlib

from . import curve, pairing
from .errors import BadArgs
from .field import FR_PRIMITIVE_ROOT, R, fr_batch_inv

FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_KZG_BATCH_DOMAIN = b"RCKZGBATCH___V1_"
NUM_G2_POINTS = 65

# Error kinds: a G1 encoding that does not decode to a curve point; a point
# outside the r-torsion subgroup; a field element (a blob's, z's or y's)
# not below r; a blob, point or batch of the wrong length.
ERROR_KINDS = ("invalid_g1", "not_in_subgroup", "non_canonical", "bad_length")


class RefError(Exception):
    def __init__(self, kind: str):
        super().__init__(kind)
        self.kind = kind


class Setup:
    """A trusted setup as c-kzg loads it: the Lagrange-form G1 points in
    bit-reversed order (decoded on first use, as only the prover needs
    them), [s]G2, and the bit-reversed roots of unity."""

    def __init__(self, path: str, field_elements_per_blob: int):
        with open(path) as fh:
            words = fh.read().split()
        n1, n2 = int(words[0]), int(words[1])
        if n1 != field_elements_per_blob or n2 != NUM_G2_POINTS or len(words) != 2 + n1 + n2:
            raise ValueError(f"{path}: {n1} G1 and {n2} G2 points, expected {field_elements_per_blob} and {NUM_G2_POINTS}")
        self.fe = n1
        self._g1_hex = words[2 : 2 + n1]
        self._g1 = None
        self.g2_s = curve.g2_uncompress(bytes.fromhex(words[2 + n1 + 1]))
        scale = n1.bit_length() - 1
        if 1 << scale != n1:
            raise ValueError(f"{n1} field elements: not a power of two")
        root = pow(FR_PRIMITIVE_ROOT, (R - 1) >> scale, R)
        natural = [1]
        for _ in range(n1 - 1):
            natural.append(natural[-1] * root % R)
        self.roots = bit_reversed(natural)
        self.root_index = {w: i for i, w in enumerate(self.roots)}

    @property
    def g1_lagrange(self) -> list:
        if self._g1 is None:
            self._g1 = bit_reversed([curve.g1_uncompress(bytes.fromhex(h)) for h in self._g1_hex])
        return self._g1


def bit_reversed(values: list) -> list:
    n = len(values)
    bits = n.bit_length() - 1
    return [values[int(f"{i:0{bits}b}"[::-1], 2) if bits else 0] for i in range(n)]


class Memo:
    """What an input always gives, kept by its bytes: a 48-byte string's
    point (or its error kind), and a (blob, commitment) pair's challenge
    and evaluation (or the blob's error kind)."""

    def __init__(self):
        self.points: dict[bytes, object] = {}
        self.evals: dict[tuple[bytes, bytes], object] = {}


# -- conversions (specs: bytes_to_bls_field, validate_kzg_g1) ---------------


def bytes_to_field(b: bytes) -> int:
    if len(b) != 32:
        raise RefError("bad_length")
    v = int.from_bytes(b, "big")
    if v >= R:
        raise RefError("non_canonical")
    return v


def decode_g1(b: bytes, subgroup_check: bool = True):
    """validate_kzg_g1: decode (on the curve), then the subgroup check."""
    if len(b) != 48:
        raise RefError("bad_length")
    try:
        p = curve.g1_uncompress(bytes(b))
    except BadArgs:
        raise RefError("invalid_g1") from None
    if subgroup_check and p is not None and not curve.g1_in_subgroup(p):
        raise RefError("not_in_subgroup")
    return p


def blob_to_polynomial(setup: Setup, blob: bytes) -> list[int]:
    if len(blob) != 32 * setup.fe:
        raise RefError("bad_length")
    return [bytes_to_field(blob[32 * i : 32 * i + 32]) for i in range(setup.fe)]


def compute_challenge(setup: Setup, blob: bytes, commitment: bytes) -> int:
    """SHA-256 of the domain, the degree as 16 bytes, the blob and the
    commitment, reduced mod r (specs: compute_challenge)."""
    h = hashlib.sha256(FIAT_SHAMIR_PROTOCOL_DOMAIN)
    h.update(setup.fe.to_bytes(16, "big"))
    h.update(bytes(blob))
    h.update(bytes(commitment))
    return int.from_bytes(h.digest(), "big") % R


def evaluate(setup: Setup, evals: list[int], z: int) -> int:
    """evaluate_polynomial_in_evaluation_form: the stored value where z is
    a root of the domain, else the barycentric formula."""
    m = setup.root_index.get(z)
    if m is not None:
        return evals[m]
    n = setup.fe
    inv = fr_batch_inv([(z - w) % R for w in setup.roots])
    s = sum(e * w % R * i for e, w, i in zip(evals, setup.roots, inv)) % R
    return s * pow(n, -1, R) % R * (pow(z, n, R) - 1) % R


# -- the prover ---------------------------------------------------------------


def blob_to_kzg_commitment(setup: Setup, blob: bytes) -> bytes:
    evals = blob_to_polynomial(setup, blob)
    return curve.g1_compress(curve.g1_lincomb_pippenger(setup.g1_lagrange, evals))


def compute_kzg_proof_impl(setup: Setup, evals: list[int], z: int) -> tuple[bytes, int]:
    y = evaluate(setup, evals, z)
    roots = setup.roots
    m = setup.root_index.get(z)
    if m is None:
        inv = fr_batch_inv([(w - z) % R for w in roots])
        q = [(e - y) * i % R for e, i in zip(evals, inv)]
    else:
        den = [1 if i == m else (w - z) % R for i, w in enumerate(roots)]
        inv = fr_batch_inv(den)
        q = [(e - y) * v % R for e, v in zip(evals, inv)]
        inv2 = fr_batch_inv([1 if i == m else (z - w) * z % R for i, w in enumerate(roots)])
        q[m] = sum((evals[i] - y) * roots[i] % R * inv2[i] for i in range(setup.fe) if i != m) % R
    return curve.g1_compress(curve.g1_lincomb_pippenger(setup.g1_lagrange, q)), y


def compute_kzg_proof(setup: Setup, blob: bytes, z_bytes: bytes) -> tuple[bytes, bytes]:
    evals = blob_to_polynomial(setup, blob)
    proof, y = compute_kzg_proof_impl(setup, evals, bytes_to_field(z_bytes))
    return proof, y.to_bytes(32, "big")


def compute_blob_kzg_proof(setup: Setup, blob: bytes, commitment: bytes, bind_commitment: bool = True) -> bytes:
    """``bind_commitment=False`` is the control: a Fiat-Shamir challenge
    that leaves the commitment out (hashes 48 zero bytes in its place), so
    the proof no longer binds the commitment it was asked for."""
    evals = blob_to_polynomial(setup, blob)
    decode_g1(commitment)
    z = compute_challenge(setup, blob, commitment if bind_commitment else bytes(48))
    return compute_kzg_proof_impl(setup, evals, z)[0]


# -- verification -------------------------------------------------------------


def _point(memo: Memo, b: bytes, subgroup_check: bool):
    key = bytes(b) if subgroup_check else b"nosub" + bytes(b)
    got = memo.points.get(key)
    if got is None:
        try:
            got = ("ok", decode_g1(b, subgroup_check))
        except RefError as e:
            got = ("err", e.kind)
        memo.points[key] = got
    if got[0] == "err":
        raise RefError(got[1])
    return got[1]


def _challenge_and_eval(setup: Setup, memo: Memo, blob: bytes, commitment: bytes):
    key = (blob, bytes(commitment))
    got = memo.evals.get(key)
    if got is None:
        try:
            evals = blob_to_polynomial(setup, blob)
            z = compute_challenge(setup, blob, commitment)
            got = ("ok", (z, evaluate(setup, evals, z)))
        except RefError as e:
            got = ("err", e.kind)
        memo.evals[key] = got
    if got[0] == "err":
        raise RefError(got[1])
    return got[1]


def verify_kzg_proof_impl(setup: Setup, commitment, z: int, y: int, proof) -> bool:
    """e(C - [y]G1, G2) == e(proof, [s]G2 - [z]G2)."""
    x_minus_z = curve.g2_sub(setup.g2_s, curve.g2_mul(curve.G2_GENERATOR, z))
    p_minus_y = curve.g1_sub(commitment, curve.g1_mul(curve.G1_GENERATOR, y))
    return pairing.pairings_verify(p_minus_y, curve.G2_GENERATOR, proof, x_minus_z)


def verify_kzg_proof(setup: Setup, commitment: bytes, z: bytes, y: bytes, proof: bytes) -> bool:
    c = decode_g1(commitment)
    zf, yf = bytes_to_field(z), bytes_to_field(y)
    return verify_kzg_proof_impl(setup, c, zf, yf, decode_g1(proof))


def verify_blob_kzg_proof(setup: Setup, blob: bytes, commitment: bytes, proof: bytes, memo: Memo | None = None, subgroup_check: bool = True) -> bool:
    memo = memo or Memo()
    c = _point(memo, commitment, subgroup_check)
    z, y = _challenge_and_eval(setup, memo, blob, commitment)
    p = _point(memo, proof, subgroup_check)
    return verify_kzg_proof_impl(setup, c, z, y, p)


def verify_blob_kzg_proof_batch(setup: Setup, blobs, commitments, proofs, memo: Memo | None = None, subgroup_check: bool = True) -> bool:
    """The batch check of the specs: each lane's commitment, blob and proof
    validated in that order (the first refused input raises), then one
    pairing on the random linear combination with r = SHA-256 of every
    lane's (commitment, z, y, proof).  ``subgroup_check=False`` is the
    control: the points' subgroup check left out."""
    if not len(blobs) == len(commitments) == len(proofs):
        raise RefError("bad_length")
    n = len(blobs)
    if n == 0:
        return True
    if n == 1:
        return verify_blob_kzg_proof(setup, blobs[0], commitments[0], proofs[0], memo, subgroup_check)
    memo = memo or Memo()
    lanes = []
    for blob, cb, pb in zip(blobs, commitments, proofs):
        c = _point(memo, cb, subgroup_check)
        z, y = _challenge_and_eval(setup, memo, blob, cb)
        p = _point(memo, pb, subgroup_check)
        lanes.append((bytes(cb), c, z, y, bytes(pb), p))
    h = hashlib.sha256(RANDOM_CHALLENGE_KZG_BATCH_DOMAIN)
    h.update(setup.fe.to_bytes(8, "big"))
    h.update(n.to_bytes(8, "big"))
    for cb, _, z, y, pb, _ in lanes:
        h.update(cb + z.to_bytes(32, "big") + y.to_bytes(32, "big") + pb)
    r = int.from_bytes(h.digest(), "big") % R
    # lhs = sum r^i proof_i; rhs = sum r^i C_i + sum r^i z_i proof_i - [sum r^i y_i] G1,
    # each summed by distinct point.
    lhs, rhs, points = {}, {}, {}
    ry, ri = 0, 1
    for cb, c, z, y, pb, p in lanes:
        points[cb], points[pb] = c, p
        lhs[pb] = (lhs.get(pb, 0) + ri) % R
        rhs[cb] = (rhs.get(cb, 0) + ri) % R
        rhs[pb] = (rhs.get(pb, 0) + ri * z) % R
        ry = (ry + ri * y) % R
        ri = ri * r % R
    lhs_pt = curve.g1_lincomb_naive([points[k] for k in lhs], list(lhs.values()))
    rhs_pt = curve.g1_sub(
        curve.g1_lincomb_naive([points[k] for k in rhs], list(rhs.values())),
        curve.g1_mul(curve.G1_GENERATOR, ry),
    )
    return pairing.pairings_verify(lhs_pt, setup.g2_s, rhs_pt, curve.G2_GENERATOR)
