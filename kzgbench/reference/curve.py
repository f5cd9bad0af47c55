"""BLS12-381 G1 / G2 arithmetic and the ZCash point encoding for the
benchmark's plain reference (pure Python integers).

A frozen copy of the port's golden model (``golden/curve.py`` of the
ported package), imports changed only.  Points are affine tuples, ``None``
for infinity; G1 is y^2 = x^3 + 4 over Fp, G2 y^2 = x^3 + 4(1 + u) over
Fp2.
"""

from __future__ import annotations

from .errors import BadArgs
from . import field as f
from .field import P, R
from .errors import (
    MSG_EXPECT_48,
    MSG_G2_BAD_INFINITY,
    MSG_G2_EXPECT_96,
    MSG_G2_NOT_ON_CURVE,
    MSG_G2_UNCOMPRESSED_BIT,
    MSG_G2_X_RANGE,
)

# Generators (standard BLS12-381 values; reference stores the same points as
# Montgomery-form Jacobian limbs in src/consts.rs:47-154).
G1_GENERATOR = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GENERATOR = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

_B_G1 = 4
_B_G2 = (4, 4)  # 4 * (1 + u)


# ---------------------------------------------------------------------------
# G1 arithmetic (affine with branching; host-side oracle only)
# ---------------------------------------------------------------------------


def g1_is_inf(p) -> bool:
    return p is None


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1 * pow(2 * y1, -1, P)) % P
    else:
        lam = ((y2 - y1) * pow(x2 - x1, -1, P)) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(p):
    return g1_add(p, p)


# -- Jacobian internals (no per-step inversion; one inversion to convert
# back to affine).  Used by the hot host paths: scalar muls, lincombs,
# subgroup checks.  Z == 0 encodes infinity.


def _jdbl1(pt):
    x1, y1, z1 = pt
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = b * b % P
    t = x1 + b
    d = 2 * (t * t - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y1 * z1 % P
    return (x3, y3, z3)


def _jadd1(p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if (s1 + s2) % P == 0:
            return (1, 1, 0)
        return _jdbl1(p1)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    rr = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (rr * rr - j - 2 * v) % P
    y3 = (rr * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def _jto1(p):
    return (1, 1, 0) if p is None else (p[0], p[1], 1)


def _jaff1(pt):
    x, y, z = pt
    if z == 0:
        return None
    zinv = pow(z, -1, P)
    zinv2 = zinv * zinv % P
    return (x * zinv2 % P, y * zinv2 * zinv % P)


def _jmul1(pt, k: int):
    """Jacobian double-and-add; k is NOT reduced (callers decide)."""
    acc = (1, 1, 0)
    base = pt
    while k:
        if k & 1:
            acc = _jadd1(acc, base)
        base = _jdbl1(base)
        k >>= 1
    return acc


def g1_mul(p, k: int):
    """Scalar multiplication (reference: utils.rs:126-140 uses 256-bit blst_p1_mult)."""
    k %= R
    if p is None or k == 0:
        return None
    return _jaff1(_jmul1(_jto1(p), k))


def g1_sub(p, q):
    # reference: utils.rs:162-172 (cneg + add)
    return g1_add(p, g1_neg(q))


def g1_eq(p, q) -> bool:
    return p == q


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + _B_G1)) % P == 0


# GLV endomorphism phi(x, y) = (beta x, y) with beta a primitive cube root
# of unity in Fp.  On curve points phi^2 + phi + 1 = 0; the eigenvalue of
# phi on the generator is e = -z^2 (z = |BLS x|), and e^2 + e + 1 == r as
# INTEGERS, so phi(P) == [e]P  <=>  [r]P == infinity.  This makes the
# subgroup check one 128-bit scalar mul instead of a 255-bit one.
_BETA = pow(2, (P - 1) // 3, P)
_Z2 = 0xD201000000010000**2
assert _Z2 * _Z2 - _Z2 + 1 == R  # (-z^2)^2 + (-z^2) + 1 == r


def g1_in_subgroup(p) -> bool:
    """Subgroup check, equivalent to [r]P == infinity
    (reference: blst_p1_in_g1 at utils.rs:303); see the phi-eigenvalue
    derivation above."""
    if p is None:
        return True
    if not g1_is_on_curve(p):
        return False
    phi = (_BETA * p[0] % P, p[1])
    return phi == g1_neg(_jaff1(_jmul1(_jto1(p), _Z2)))


def g1_mul_unsafe(p, k: int):
    """Scalar mult without reducing k mod r (for subgroup checks)."""
    if p is None or k == 0:
        return None
    return _jaff1(_jmul1(_jto1(p), k))


# ---------------------------------------------------------------------------
# G2 arithmetic
# ---------------------------------------------------------------------------


def g2_is_inf(p) -> bool:
    return p is None


def g2_neg(p):
    if p is None:
        return None
    return (p[0], f.fp2_neg(p[1]))


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if f.fp2_eq(x1, x2):
        if f.fp2_is_zero(f.fp2_add(y1, y2)):
            return None
        lam = f.fp2_mul(
            f.fp2_mul_fp(f.fp2_sqr(x1), 3),
            f.fp2_inv(f.fp2_mul_fp(y1, 2)),
        )
    else:
        lam = f.fp2_mul(f.fp2_sub(y2, y1), f.fp2_inv(f.fp2_sub(x2, x1)))
    x3 = f.fp2_sub(f.fp2_sub(f.fp2_sqr(lam), x1), x2)
    y3 = f.fp2_sub(f.fp2_mul(lam, f.fp2_sub(x1, x3)), y1)
    return (x3, y3)


def _jdbl2(pt):
    x1, y1, z1 = pt
    a = f.fp2_sqr(x1)
    b = f.fp2_sqr(y1)
    c = f.fp2_sqr(b)
    t = f.fp2_sub(f.fp2_sub(f.fp2_sqr(f.fp2_add(x1, b)), a), c)
    d = f.fp2_add(t, t)
    e = f.fp2_mul_fp(a, 3)
    x3 = f.fp2_sub(f.fp2_sqr(e), f.fp2_add(d, d))
    c8 = f.fp2_mul_fp(c, 8)
    y3 = f.fp2_sub(f.fp2_mul(e, f.fp2_sub(d, x3)), c8)
    z3 = f.fp2_mul_fp(f.fp2_mul(y1, z1), 2)
    return (x3, y3, z3)


def _jadd2(p1, p2):
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if f.fp2_is_zero(z1):
        return p2
    if f.fp2_is_zero(z2):
        return p1
    z1z1 = f.fp2_sqr(z1)
    z2z2 = f.fp2_sqr(z2)
    u1 = f.fp2_mul(x1, z2z2)
    u2 = f.fp2_mul(x2, z1z1)
    s1 = f.fp2_mul(f.fp2_mul(y1, z2), z2z2)
    s2 = f.fp2_mul(f.fp2_mul(y2, z1), z1z1)
    if f.fp2_eq(u1, u2):
        if f.fp2_is_zero(f.fp2_add(s1, s2)):
            return (f.FP2_ONE, f.FP2_ONE, f.FP2_ZERO)
        return _jdbl2(p1)
    h = f.fp2_sub(u2, u1)
    i = f.fp2_mul_fp(f.fp2_sqr(h), 4)
    j = f.fp2_mul(h, i)
    rr = f.fp2_mul_fp(f.fp2_sub(s2, s1), 2)
    v = f.fp2_mul(u1, i)
    x3 = f.fp2_sub(f.fp2_sub(f.fp2_sqr(rr), j), f.fp2_mul_fp(v, 2))
    y3 = f.fp2_sub(
        f.fp2_mul(rr, f.fp2_sub(v, x3)), f.fp2_mul_fp(f.fp2_mul(s1, j), 2)
    )
    z3 = f.fp2_mul(
        f.fp2_sub(f.fp2_sub(f.fp2_sqr(f.fp2_add(z1, z2)), z1z1), z2z2), h
    )
    return (x3, y3, z3)


def _jaff2(pt):
    x, y, z = pt
    if f.fp2_is_zero(z):
        return None
    zinv = f.fp2_inv(z)
    zinv2 = f.fp2_sqr(zinv)
    return (f.fp2_mul(x, zinv2), f.fp2_mul(f.fp2_mul(y, zinv2), zinv))


def g2_mul(p, k: int):
    k %= R
    if p is None or k == 0:
        return None
    acc = (f.FP2_ONE, f.FP2_ONE, f.FP2_ZERO)
    base = (p[0], p[1], f.FP2_ONE)
    while k:
        if k & 1:
            acc = _jadd2(acc, base)
        base = _jdbl2(base)
        k >>= 1
    return _jaff2(acc)


def g2_sub(p, q):
    # reference: utils.rs:174-183
    return g2_add(p, g2_neg(q))


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f.fp2_eq(f.fp2_sqr(y), f.fp2_add(f.fp2_mul(f.fp2_sqr(x), x), _B_G2))


# ---------------------------------------------------------------------------
# ZCash-format (de)serialization - reference: blst compress/uncompress,
# called at utils.rs:221-310 and kzg.rs:859-887.
# ---------------------------------------------------------------------------

_FLAG_COMPRESSED = 0x80
_FLAG_INFINITY = 0x40
_FLAG_SIGN = 0x20


def g1_compress(p) -> bytes:
    """48-byte compressed encoding (reference: bytes_from_g1, utils.rs:221)."""
    if p is None:
        return bytes([0xC0] + [0] * 47)
    x, y = p
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= _FLAG_COMPRESSED
    if y > (P - 1) // 2:
        out[0] |= _FLAG_SIGN
    return bytes(out)


def g1_uncompress(data: bytes):
    """Decode 48 bytes; on-curve check included, no subgroup check.

    Mirrors blst_p1_uncompress semantics (used at utils.rs:291, kzg.rs:861).
    Raises BadArgs on any malformed encoding.
    """
    if len(data) != 48:
        raise BadArgs(MSG_EXPECT_48)
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise BadArgs("g1_uncompress: uncompressed bit not set")
    if flags & _FLAG_INFINITY:
        # All other bits must be zero.
        if flags != (_FLAG_COMPRESSED | _FLAG_INFINITY) or any(data[1:]):
            raise BadArgs("g1_uncompress: bad infinity encoding")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise BadArgs("g1_uncompress: x out of range")
    y2 = (x * x * x + _B_G1) % P
    y = f.fp_sqrt(y2)
    if y is None:
        raise BadArgs("g1_uncompress: point not on curve")
    sign = bool(flags & _FLAG_SIGN)
    if (y > (P - 1) // 2) != sign:
        y = (-y) % P
    return (x, y)


def g2_compress(p) -> bytes:
    """96-byte compressed encoding: x_c1 || x_c0 with flags on byte 0."""
    if p is None:
        return bytes([0xC0] + [0] * 95)
    (x0, x1), (y0, y1) = p
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= _FLAG_COMPRESSED
    # Sign: y lexicographically largest, ordering (c1, c0).
    neg = ((-y0) % P, (-y1) % P)
    if (y1, y0) > (neg[1], neg[0]):
        out[0] |= _FLAG_SIGN
    return bytes(out)


def g2_uncompress(data: bytes):
    """Decode 96 bytes (reference: blst_p2_uncompress at kzg.rs:876)."""
    if len(data) != 96:
        raise BadArgs(MSG_G2_EXPECT_96)
    flags = data[0]
    if not flags & _FLAG_COMPRESSED:
        raise BadArgs(MSG_G2_UNCOMPRESSED_BIT)
    if flags & _FLAG_INFINITY:
        if flags != (_FLAG_COMPRESSED | _FLAG_INFINITY) or any(data[1:]):
            raise BadArgs(MSG_G2_BAD_INFINITY)
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise BadArgs(MSG_G2_X_RANGE)
    x = (x0, x1)
    y2 = f.fp2_add(f.fp2_mul(f.fp2_sqr(x), x), _B_G2)
    y = f.fp2_sqrt(y2)
    if y is None:
        raise BadArgs(MSG_G2_NOT_ON_CURVE)
    sign = bool(flags & _FLAG_SIGN)
    y0, y1 = y
    neg = ((-y0) % P, (-y1) % P)
    if ((y1, y0) > (neg[1], neg[0])) != sign:
        y = neg
    return (x, y)


# ---------------------------------------------------------------------------
# Multi-scalar multiplication - reference: utils.rs:329-410
# ---------------------------------------------------------------------------


def g1_lincomb_naive(points, scalars):
    """Per-point mult + add (reference: utils.rs:329-342, used in
    verification).  Jacobian accumulation internally; identical result."""
    acc = (1, 1, 0)
    for p, s in zip(points, scalars):
        k = s % R
        if p is None or k == 0:
            continue
        acc = _jadd1(acc, _jmul1(_jto1(p), k))
    return _jaff1(acc)


def g1_lincomb_pippenger(points, scalars, window: int = 8):
    """Bucket-method MSM (reference: blst_p1s_mult_pippenger, utils.rs:399)."""
    n = len(points)
    if n == 0:
        return None
    if n < 8:
        # reference: utils.rs:369-371 falls back to naive below 8 points
        return g1_lincomb_naive(points, scalars)
    scalars = [s % R for s in scalars]  # same semantics as the naive path
    nbits = 255
    nwin = (nbits + window - 1) // window
    inf = (1, 1, 0)
    jpts = [_jto1(p) for p in points]
    acc = inf
    for w in range(nwin - 1, -1, -1):
        if acc[2] != 0:
            for _ in range(window):
                acc = _jdbl1(acc)
        buckets = [inf] * (1 << window)
        shift = w * window
        for jp, s in zip(jpts, scalars):
            d = (s >> shift) & ((1 << window) - 1)
            if d:
                buckets[d] = _jadd1(buckets[d], jp)
        running = inf
        win_sum = inf
        for d in range((1 << window) - 1, 0, -1):
            running = _jadd1(running, buckets[d])
            win_sum = _jadd1(win_sum, running)
        acc = _jadd1(acc, win_sum)
    return _jaff1(acc)
