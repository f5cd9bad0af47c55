"""BLS12-381 pairing (Miller loop + final exponentiation) for the benchmark's
plain reference: a frozen copy of the port's golden model
(``golden/pairing.py`` of the ported package), imports changed only.

Re-creates the blst pairing surface used by the reference's
``pairings_verify`` (reference: src/utils.rs:189-214): two Miller loops, an
Fp12 multiply, one final exponentiation, and an is-one check.

Design notes:

* G2 points stay on the twist E'(Fp2): y^2 = x^3 + 4(1+u). Line functions
  are evaluated through the untwist map psi(x', y') = (x' w^-2, y' w^-3)
  into E(Fp12), which lands on the sparse Fp12 components {w^0, w^3, w^5}.
* Every line is scaled by xi = 1+u (an Fp2 element, annihilated by the
  final exponentiation) so no Fp2 division is needed to build it.
* The Miller loop runs over |x|, x = -0xd201000000010000; the result is
  conjugated at the end because x < 0.
* Final exponentiation: easy part via conjugation/inversion/Frobenius, hard
  part as a plain square-and-multiply by (p^4 - p^2 + 1) / r. (The x-based
  addition chain is a later optimization; this is the oracle.)
"""

from __future__ import annotations

from . import field as f
from .field import BLS_X, P, R

# Hard-part exponent of the final exponentiation.  The x-based chain below
# computes the CUBE of the standard hard part: for BLS12 curves
#   (x-1)^2 (x+p) (x^2+p^2-1) + 3 == 3 * (p^4-p^2+1)/r
# (verified at import).  Since pairing values live in mu_r and 3 does not
# divide r, cubing is a bijection on that group, so is-one checks (the only
# consumer, ``pairings_verify``) are unchanged - the same trick blst-class
# implementations use.
_HARD_EXP = (P**4 - P**2 + 1) // R
assert (P**4 - P**2 + 1) % R == 0
_SIGNED_X = -BLS_X
assert (_SIGNED_X - 1) ** 2 * (_SIGNED_X + P) * (
    _SIGNED_X**2 + P**2 - 1
) + 3 == 3 * _HARD_EXP
assert R % 3 != 0

_XI = f.XI

# Bits of |x| below the MSB, most significant first.
_X_BITS = [(BLS_X >> i) & 1 for i in range(BLS_X.bit_length() - 2, -1, -1)]


def _line(t1, t2, lam, p_g1):
    """The untwisted line through psi(t1), psi(t2) (slope lam), eval at P.

    Returns the sparse Fp12 element xi * l(P):
      c_even = (xi * yP, 0, 0);  c_odd = (0, lam*x1 - y1, -lam*xP)
    with v = w^2 tower coordinates (w^3 = v*w, w^5 = v^2*w).
    """
    del t2  # the line depends only on one point and the slope
    xp, yp = p_g1
    x1, y1 = t1
    c00 = f.fp2_mul_fp(_XI, yp)
    c11 = f.fp2_sub(f.fp2_mul(lam, x1), y1)
    c12 = f.fp2_neg(f.fp2_mul_fp(lam, xp))
    return ((c00, f.FP2_ZERO, f.FP2_ZERO), (f.FP2_ZERO, c11, c12))


def miller_loop(p_g1, q_g2):
    """f_{x,Q}(P) with the BLS12 sign convention (conjugate for x < 0).

    Accepts ``None`` (infinity) for either argument and returns one, matching
    blst's behavior when fed infinity.
    """
    if p_g1 is None or q_g2 is None:
        return f.FP12_ONE

    fx = f.FP12_ONE
    t = q_g2
    for bit in _X_BITS:
        # Doubling step: slope of the tangent at t.
        x1, y1 = t
        lam = f.fp2_mul(
            f.fp2_mul_fp(f.fp2_sqr(x1), 3),
            f.fp2_inv(f.fp2_mul_fp(y1, 2)),
        )
        fx = f.fp12_mul(f.fp12_sqr(fx), _line(t, t, lam, p_g1))
        x3 = f.fp2_sub(f.fp2_sub(f.fp2_sqr(lam), x1), x1)
        y3 = f.fp2_sub(f.fp2_mul(lam, f.fp2_sub(x1, x3)), y1)
        t = (x3, y3)
        if bit:
            # Addition step: chord through t and q.
            x1, y1 = t
            x2, y2 = q_g2
            lam = f.fp2_mul(f.fp2_sub(y2, y1), f.fp2_inv(f.fp2_sub(x2, x1)))
            fx = f.fp12_mul(fx, _line(t, q_g2, lam, p_g1))
            x3 = f.fp2_sub(f.fp2_sub(f.fp2_sqr(lam), x1), x2)
            y3 = f.fp2_sub(f.fp2_mul(lam, f.fp2_sub(x1, x3)), y1)
            t = (x3, y3)

    # x is negative: f_{-|x|} contributes an inversion, which commutes with
    # the final exponentiation as a conjugation.
    return f.fp12_conj(fx)


def _exp_by_x(m):
    """m^x for cyclotomic m (x = -|BLS_X|): square-and-multiply by |x| with
    Granger-Scott squarings, then conjugate (the cyclotomic inverse)."""
    r = m
    for bit in _X_BITS:
        r = f.fp12_cyclo_sqr(r)
        if bit:
            r = f.fp12_mul(r, m)
    return f.fp12_conj(r)


def final_exponentiation(x):
    """x^(3 * (p^12 - 1) / r) - the cubed final exponentiation (see the
    module-top identity).  is-one semantics identical to the standard map."""
    # Easy part: x^(p^6 - 1), then ^(p^2 + 1).  Lands in the cyclotomic
    # subgroup, where inverse == conjugate and Granger-Scott squaring holds.
    m = f.fp12_mul(f.fp12_conj(x), f.fp12_inv(x))
    m = f.fp12_mul(f.fp12_frobenius_n(m, 2), m)
    # Hard part via the x-chain: m^((x-1)^2 (x+p) (x^2+p^2-1) + 3).
    u = f.fp12_mul(_exp_by_x(m), f.fp12_conj(m))  # m^(x-1)
    u = f.fp12_mul(_exp_by_x(u), f.fp12_conj(u))  # m^((x-1)^2)
    w1 = f.fp12_mul(_exp_by_x(u), f.fp12_frobenius(u))  # ^(x+p)
    y = f.fp12_mul(
        f.fp12_mul(_exp_by_x(_exp_by_x(w1)), f.fp12_frobenius_n(w1, 2)),
        f.fp12_conj(w1),
    )  # ^(x^2 + p^2 - 1)
    return f.fp12_mul(y, f.fp12_mul(f.fp12_cyclo_sqr(m), m))  # * m^3


def pairings_verify(a1, a2, b1, b2) -> bool:
    """e(a1, a2) == e(b1, b2), computed as e(-a1, a2) * e(b1, b2) == 1.

    Mirrors the reference exactly (reference: utils.rs:189-214): negate a1,
    two Miller loops, fp12 multiply, one final exponentiation, is-one check.
    a1/b1 are G1 points, a2/b2 are G2 points (affine, None == infinity).
    """
    from .curve import g1_neg

    f1 = miller_loop(g1_neg(a1), a2)
    f2 = miller_loop(b1, b2)
    return f.fp12_is_one(final_exponentiation(f.fp12_mul(f1, f2)))
