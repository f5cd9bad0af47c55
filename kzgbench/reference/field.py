"""BLS12-381 field arithmetic for the benchmark's plain reference (pure
Python integers): Fp, Fr and the Fp2 / Fp6 / Fp12 tower.

A frozen copy of the port's golden model (``golden/field.py`` of the
ported package), imports changed only, so that the yardstick does not move
with the program: Fp2 = Fp[u]/(u^2 + 1) as (c0, c1), Fp6 over Fp2 with
v^3 = 1 + u, Fp12 over Fp6 with w^2 = v; canonical integers, no Montgomery
form.
"""

from __future__ import annotations
from .errors import MSG_BATCH_INV_ZERO

# The BLS12-381 base-field modulus p (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# The scalar-field modulus r (255 bits) = order of G1/G2.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# The BLS family parameter x (negative: x = -0xd201000000010000).
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

# Primitive root of the multiplicative group of Fr, used to derive the
# 2^k-th roots of unity (reference: src/consts.rs:163-168 documents
# SCALE2_ROOT_OF_UNITY[k] = 7 ** ((r - 1) / 2^k) mod r).
FR_PRIMITIVE_ROOT = 7

FP_ZERO = 0
FP_ONE = 1

# ---------------------------------------------------------------------------
# Fr (scalar field) helpers - reference: src/utils.rs:10-123
# ---------------------------------------------------------------------------


def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R


def fr_sqr(a: int) -> int:
    return (a * a) % R


def fr_neg(a: int) -> int:
    return (-a) % R


def fr_inv(a: int) -> int:
    return pow(a, -1, R)


def fr_div(a: int, b: int) -> int:
    # reference: utils.rs:42 (a / b via eucl_inverse)
    return (a * pow(b, -1, R)) % R


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, R)


def fr_batch_inv(values: list[int]) -> list[int]:
    """Montgomery batch inversion (reference: utils.rs:94-123).

    Matches the reference's semantics exactly: errors on empty input, and
    detects zeros only via the running product being zero.
    """
    from .errors import BadArgs

    if len(values) == 0:
        raise BadArgs("fr_batch_inv: empty input")
    prods = []
    acc = 1
    for v in values:
        acc = (acc * v) % R
        prods.append(acc)
    if acc == 0:
        raise BadArgs(MSG_BATCH_INV_ZERO)
    inv = pow(acc, -1, R)
    out = [0] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = (inv * prods[i - 1]) % R
        inv = (inv * values[i]) % R
    out[0] = inv
    return out


def fr_scale2_root_of_unity(scale: int) -> int:
    """The primitive 2^scale-th root of unity in Fr.

    Re-creates SCALE2_ROOT_OF_UNITY[scale] (reference: consts.rs:179-372)
    from its documented generating formula instead of a hardcoded table.
    """
    if scale < 0 or scale > 32:
        from .errors import BadArgs

        raise BadArgs("compute_roots_of_unity: max_scale too large")
    return pow(FR_PRIMITIVE_ROOT, (R - 1) >> scale, R)


# ---------------------------------------------------------------------------
# Fp (base field) helpers
# ---------------------------------------------------------------------------


def fp_inv(a: int) -> int:
    return pow(a, -1, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (p = 3 mod 4): a^((p+1)/4); None if non-residue."""
    cand = pow(a, (P + 1) // 4, P)
    if (cand * cand) % P == a % P:
        return cand
    return None


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1), elements are tuples (c0, c1) = c0 + c1*u
# ---------------------------------------------------------------------------

Fp2 = tuple  # (int, int)

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
# xi = 1 + u, the Fp6 non-residue.
XI = (1, 1)


def fp2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a: Fp2) -> Fp2:
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_conj(a: Fp2) -> Fp2:
    return (a[0], (-a[1]) % P)


def fp2_mul(a: Fp2, b: Fp2) -> Fp2:
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0*b1 + a1*b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fp2_sqr(a: Fp2) -> Fp2:
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return (((a0 + a1) * (a0 - a1)) % P, (2 * a0 * a1) % P)


def fp2_mul_fp(a: Fp2, k: int) -> Fp2:
    return ((a[0] * k) % P, (a[1] * k) % P)


def fp2_inv(a: Fp2) -> Fp2:
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = pow(norm, -1, P)
    return ((a0 * ninv) % P, ((-a1) * ninv) % P)


def fp2_is_zero(a: Fp2) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fp2_eq(a: Fp2, b: Fp2) -> bool:
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


def fp2_pow(a: Fp2, e: int) -> Fp2:
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def _find_fp2_nonresidue() -> Fp2:
    """A quadratic non-residue in Fp2, found via the Euler criterion."""
    q = P * P
    for c0, c1 in ((1, 1), (0, 1), (2, 1), (1, 2), (3, 1)):
        cand = (c0, c1)
        if fp2_pow(cand, (q - 1) // 2) != FP2_ONE:
            return cand
    raise RuntimeError("no Fp2 non-residue found")  # pragma: no cover


_FP2_NONRESIDUE: Fp2 | None = None


def fp2_sqrt(a: Fp2) -> Fp2 | None:
    """Square root in Fp2 via Tonelli-Shanks (q = p^2, q-1 = 2^3 * t)."""
    global _FP2_NONRESIDUE
    if fp2_is_zero(a):
        return FP2_ZERO
    q = P * P
    s, t = 0, q - 1
    while t % 2 == 0:
        s += 1
        t //= 2
    if _FP2_NONRESIDUE is None:
        _FP2_NONRESIDUE = _find_fp2_nonresidue()
    z = fp2_pow(_FP2_NONRESIDUE, t)
    m = s
    c = z
    u = fp2_pow(a, t)
    r = fp2_pow(a, (t + 1) // 2)
    while not fp2_eq(u, FP2_ONE):
        # find least i with u^(2^i) == 1
        i = 0
        u2 = u
        while not fp2_eq(u2, FP2_ONE):
            u2 = fp2_sqr(u2)
            i += 1
            if i == m:
                return None  # non-residue
        b = c
        for _ in range(m - i - 1):
            b = fp2_sqr(b)
        m = i
        c = fp2_sqr(b)
        u = fp2_mul(u, c)
        r = fp2_mul(r, b)
    if fp2_eq(fp2_sqr(r), a):
        return r
    return None


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi), elements are 3-tuples of Fp2
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul(XI, fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)),
        fp2_mul(XI, t2),
    )
    c2 = fp2_add(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """Multiply by v: (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2."""
    return (fp2_mul(XI, a[2]), a[0], a[1])


def fp6_mul_fp2(a, k: Fp2):
    return (fp2_mul(a[0], k), fp2_mul(a[1], k), fp2_mul(a[2], k))


def fp6_inv(a):
    a0, a1, a2 = a
    t0 = fp2_sub(fp2_sqr(a0), fp2_mul(XI, fp2_mul(a1, a2)))
    t1 = fp2_sub(fp2_mul(XI, fp2_sqr(a2)), fp2_mul(a0, a1))
    t2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    factor = fp2_add(
        fp2_mul(a0, t0),
        fp2_mul(XI, fp2_add(fp2_mul(a2, t1), fp2_mul(a1, t2))),
    )
    finv = fp2_inv(factor)
    return (fp2_mul(t0, finv), fp2_mul(t1, finv), fp2_mul(t2, finv))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w] / (w^2 - v), elements are 2-tuples of Fp6
# ---------------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    # Complex squaring: (a0 + a1 w)^2 = a0^2 + v a1^2 + 2 a0 a1 w, computed
    # with two Fp6 multiplies instead of fp12_mul's three.
    a0, a1 = a
    t = fp6_mul(a0, a1)
    c0 = fp6_sub(
        fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_by_v(a1))), t),
        fp6_mul_by_v(t),
    )
    return (c0, fp6_add(t, t))


def fp12_conj(a):
    """Conjugation over Fp6 == the p^6 Frobenius."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    # (a0 + a1 w)^-1 = (a0 - a1 w) / (a0^2 - a1^2 v)
    norm = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    ninv = fp6_inv(norm)
    return (fp6_mul(a0, ninv), fp6_neg(fp6_mul(a1, ninv)))


def fp12_pow(a, e: int):
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


def fp12_cyclo_sqr(a):
    """Granger-Scott squaring, valid only in the cyclotomic subgroup
    (elements of norm 1, i.e. anything after the easy part of the final
    exponentiation).  9 Fp2 squarings versus 18 Fp2 multiplies for the
    generic ``fp12_sqr``."""
    (g0, g1, g2), (g3, g4, g5) = a

    t0 = fp2_sqr(g4)
    t1 = fp2_sqr(g0)
    t6 = fp2_sub(fp2_sub(fp2_sqr(fp2_add(g4, g0)), t0), t1)  # 2 g0 g4
    t2 = fp2_sqr(g2)
    t3 = fp2_sqr(g3)
    t7 = fp2_sub(fp2_sub(fp2_sqr(fp2_add(g2, g3)), t2), t3)  # 2 g2 g3
    t4 = fp2_sqr(g5)
    t5 = fp2_sqr(g1)
    t8 = fp2_mul(XI, fp2_sub(fp2_sub(fp2_sqr(fp2_add(g5, g1)), t4), t5))  # 2 g1 g5 xi

    t0 = fp2_add(fp2_mul(XI, t0), t1)  # g0^2 + xi g4^2
    t2 = fp2_add(fp2_mul(XI, t2), t3)  # g3^2 + xi g2^2
    t4 = fp2_add(fp2_mul(XI, t4), t5)  # g1^2 + xi g5^2

    z0 = fp2_add(fp2_mul_fp(fp2_sub(t0, g0), 2), t0)  # 3 t0 - 2 g0
    z1 = fp2_add(fp2_mul_fp(fp2_sub(t2, g1), 2), t2)
    z2 = fp2_add(fp2_mul_fp(fp2_sub(t4, g2), 2), t4)
    z3 = fp2_add(fp2_mul_fp(fp2_add(t8, g3), 2), t8)  # 3 t8 + 2 g3
    z4 = fp2_add(fp2_mul_fp(fp2_add(t6, g4), 2), t6)
    z5 = fp2_add(fp2_mul_fp(fp2_add(t7, g5), 2), t7)
    return ((z0, z1, z2), (z3, z4, z5))


def fp12_eq(a, b) -> bool:
    return a == b


def fp12_is_one(a) -> bool:
    return a == FP12_ONE


# Frobenius: gamma = xi^((p-1)/6) in Fp2; frob(w^k coeff) = conj(coeff)*gamma^k.
# The Fp12 basis over Fp2 is {1, v, v^2, w, vw, v^2w} = w^{0,2,4,1,3,5}.
_GAMMA = fp2_pow(XI, (P - 1) // 6)
_GAMMA_POWERS = [FP2_ONE]
for _ in range(5):
    _GAMMA_POWERS.append(fp2_mul(_GAMMA_POWERS[-1], _GAMMA))


def fp12_frobenius(a):
    """The p-power Frobenius endomorphism on Fp12."""
    (c0, c2, c4), (c1, c3, c5) = a  # coeff of w^{0,2,4} and w^{1,3,5}
    c0 = fp2_conj(c0)
    c1 = fp2_mul(fp2_conj(c1), _GAMMA_POWERS[1])
    c2 = fp2_mul(fp2_conj(c2), _GAMMA_POWERS[2])
    c3 = fp2_mul(fp2_conj(c3), _GAMMA_POWERS[3])
    c4 = fp2_mul(fp2_conj(c4), _GAMMA_POWERS[4])
    c5 = fp2_mul(fp2_conj(c5), _GAMMA_POWERS[5])
    return ((c0, c2, c4), (c1, c3, c5))


def fp12_frobenius_n(a, n: int):
    for _ in range(n):
        a = fp12_frobenius(a)
    return a
