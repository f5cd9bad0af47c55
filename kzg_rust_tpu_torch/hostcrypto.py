"""Host-side crypto dispatch: the native C++ host engine or the golden model.

The reference delegates every host-side curve operation to blst (C + asm);
this module is the port's equivalent seam, as ``hostcrypto`` is the JAX
package's.  When the native engine (``native/kzg_native.cpp``, built and
loaded by :mod:`kzg_rust_tpu_torch.native`) loads, it runs the scalar work:
point (de)serialization, subgroup checks, single scalar multiplications,
the pairing check, and the fused host contexts.  Where it does not load,
everything falls back to the pure-Python golden model, which gives the same
bits (tests/test_torch_native.py holds the two against each other).  This
chooses between two host implementations; the card's work is not here.

Set ``KZG_TORCH_NATIVE=0`` to force the pure-Python path.
"""

from __future__ import annotations

from .golden import curve as _gc
from .golden import pairing as _gp


def _nat():
    from . import native

    return native if native.available() else None


# -- G1 serialization / validation ------------------------------------------


def g1_uncompress(data: bytes):
    n = _nat()
    if n is not None and len(data) == 48:
        return n.g1_uncompress(data)
    return _gc.g1_uncompress(data)


def g1_uncompress_batch(datas):
    """Decode many compressed points (parallel in the native runtime);
    raises BadArgs on the first malformed encoding."""
    n = _nat()
    if n is not None and all(len(d) == 48 for d in datas):
        return n.g1_uncompress_batch(datas)
    return [_gc.g1_uncompress(bytes(d)) for d in datas]


def g1_compress(p) -> bytes:
    n = _nat()
    return n.g1_compress(p) if n is not None else _gc.g1_compress(p)


def g2_uncompress(data: bytes):
    # Native Fp2 sqrt (eprint 2012/685 alg 9) when the engine is built,
    # golden Tonelli-Shanks otherwise; setup-time only (65 points,
    # disk-cached afterwards).
    n = _nat()
    return n.g2_uncompress(data) if n is not None else _gc.g2_uncompress(data)


def g1_in_subgroup(p) -> bool:
    n = _nat()
    return n.g1_in_subgroup(p) if n is not None else _gc.g1_in_subgroup(p)


def g1_subgroup_batch(points) -> bool:
    """True iff every point is in G1 (infinity passes)."""
    n = _nat()
    if n is not None:
        return n.g1_subgroup_batch(points)
    return all(_gc.g1_in_subgroup(p) for p in points)


# -- group arithmetic --------------------------------------------------------


def g1_mul(p, k: int):
    n = _nat()
    return n.g1_mul(p, k) if n is not None else _gc.g1_mul(p, k)


def g1_add(p, q):
    n = _nat()
    return n.g1_add(p, q) if n is not None else _gc.g1_add(p, q)


def g1_sub(p, q):
    n = _nat()
    return n.g1_sub(p, q) if n is not None else _gc.g1_sub(p, q)


def g2_mul(p, k: int):
    n = _nat()
    return n.g2_mul(p, k) if n is not None else _gc.g2_mul(p, k)


def g2_add(p, q):
    n = _nat()
    return n.g2_add(p, q) if n is not None else _gc.g2_add(p, q)


def g2_sub(p, q):
    n = _nat()
    return n.g2_sub(p, q) if n is not None else _gc.g2_sub(p, q)


def g1_lincomb_naive(points, scalars):
    n = _nat()
    if n is not None:
        return n.g1_lincomb_naive(points, scalars)
    return _gc.g1_lincomb_naive(points, scalars)


def pairings_verify(a1, a2, b1, b2) -> bool:
    n = _nat()
    if n is not None:
        return n.pairings_verify(a1, a2, b1, b2)
    return _gp.pairings_verify(a1, a2, b1, b2)


# -- barycentric evaluation (native only; callers fall back themselves) ------


def bary_ctx(roots_of_unity):
    """A reusable native barycentric-evaluation context, or None when the
    native runtime is unavailable."""
    n = _nat()
    if n is None:
        return None
    return n.BaryCtx(roots_of_unity)


def verify_ctx(roots_of_unity, g2_s, g2_gen, fs_domain: bytes, rc_domain: bytes):
    """A reusable fused batch-verification context, or None when the native
    runtime is unavailable."""
    n = _nat()
    if n is None:
        return None
    return n.VerifyCtx(roots_of_unity, g2_s, g2_gen, fs_domain, rc_domain)


def prover_ctx(roots_of_unity, g1_lagrange, fs_domain: bytes):
    """A reusable fused prover context (commit / prove / blob-proof over the
    Lagrange setup), or None when the native runtime is unavailable."""
    n = _nat()
    if n is None:
        return None
    return n.ProverCtx(roots_of_unity, g1_lagrange, fs_domain)
