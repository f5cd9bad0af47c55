"""Host-side crypto dispatch: the pure-Python golden model.

The port keeps the seam of the JAX package's ``hostcrypto`` (point
(de)serialization, subgroup checks, single scalar multiplications, the
pairing check) but only its golden branch: the ctypes hookup to the native
C++ host engine (``native/kzg_native.cpp``) is a later slice, so the one
pairing that ends a batch verification is the pure-Python one.
"""

from __future__ import annotations

from .golden import curve as _gc
from .golden import pairing as _gp


# -- G1 serialization / validation ------------------------------------------


def g1_uncompress(data: bytes):
    return _gc.g1_uncompress(data)


def g1_uncompress_batch(datas):
    """Decode many compressed points; raises BadArgs on the first
    malformed encoding."""
    return [_gc.g1_uncompress(bytes(d)) for d in datas]


def g1_compress(p) -> bytes:
    return _gc.g1_compress(p)


def g2_uncompress(data: bytes):
    return _gc.g2_uncompress(data)


def g1_in_subgroup(p) -> bool:
    return _gc.g1_in_subgroup(p)


def g1_subgroup_batch(points) -> bool:
    """True iff every point is in G1 (infinity passes)."""
    return all(_gc.g1_in_subgroup(p) for p in points)


# -- group arithmetic --------------------------------------------------------


def g1_mul(p, k: int):
    return _gc.g1_mul(p, k)


def g1_add(p, q):
    return _gc.g1_add(p, q)


def g1_sub(p, q):
    return _gc.g1_sub(p, q)


def g2_mul(p, k: int):
    return _gc.g2_mul(p, k)


def g2_add(p, q):
    return _gc.g2_add(p, q)


def g2_sub(p, q):
    return _gc.g2_sub(p, q)


def g1_lincomb_naive(points, scalars):
    return _gc.g1_lincomb_naive(points, scalars)


def pairings_verify(a1, a2, b1, b2) -> bool:
    return _gp.pairings_verify(a1, a2, b1, b2)
