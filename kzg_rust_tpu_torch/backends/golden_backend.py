"""Host backend: golden-model orchestration.

Group operations route through :mod:`kzg_rust_tpu_torch.hostcrypto`: the
native host engine where it loads, else the pure-Python golden model (the
same bits); the polynomial math and the fixed-base MSM here are golden.
"""

from __future__ import annotations

from .. import hostcrypto
from ..golden import curve
from ..golden.field import (
    R,
    fr_batch_inv,
    fr_div,
    fr_mul,
    fr_pow,
    fr_sub,
)


class GoldenBackend:
    name = "golden"

    # -- polynomial math ----------------------------------------------------

    def barycentric_eval(self, settings, evals, x: int) -> int:
        """p(x) = ((x^n - 1)/n) * sum evals_i * w_i / (x - w_i)
        (reference: kzg.rs:346-389; the in-domain short-circuit is handled by
        the protocol layer before calling this)."""
        n = settings.preset.field_elements_per_blob
        roots = settings.roots_of_unity
        inverses = fr_batch_inv([fr_sub(x, roots[i]) % R for i in range(n)])
        res = 0
        for i in range(n):
            res = (res + inverses[i] * roots[i] % R * evals[i]) % R
        res = fr_div(res, n % R)
        res = fr_mul(res, fr_sub(fr_pow(x, n), 1))
        return res

    def quotient_out_of_domain(self, settings, evals, z: int, y: int) -> list[int]:
        """q_i = (p_i - y) / (w_i - z) (reference: kzg.rs:468-491)."""
        n = settings.preset.field_elements_per_blob
        roots = settings.roots_of_unity
        inverses = fr_batch_inv([fr_sub(roots[i], z) for i in range(n)])
        return [fr_mul(fr_sub(evals[i], y), inverses[i]) for i in range(n)]

    def quotient_in_domain(self, settings, evals, z: int, y: int, m: int) -> list[int]:
        """z == w_m: q_i = (p_i - y)/(w_i - z) for i != m;
        q_m = sum_{i != m} (p_i - y) * w_i / (z * (z - w_i))
        (reference: kzg.rs:471-523)."""
        n = settings.preset.field_elements_per_blob
        roots = settings.roots_of_unity
        den1 = [1 if i == m else fr_sub(roots[i], z) for i in range(n)]
        inv1 = fr_batch_inv(den1)
        q = [fr_mul(fr_sub(evals[i], y), inv1[i]) for i in range(n)]
        den2 = [1 if i == m else fr_mul(fr_sub(z, roots[i]), z) for i in range(n)]
        inv2 = fr_batch_inv(den2)
        qm = 0
        for i in range(n):
            if i == m:
                continue
            t = fr_mul(fr_mul(fr_sub(evals[i], y), roots[i]), inv2[i])
            qm = (qm + t) % R
        q[m] = qm
        return q

    # -- group ops ----------------------------------------------------------

    def msm_g1_lagrange(self, settings, scalars):
        """Fixed-base MSM over the Lagrange setup points
        (reference: g1_lincomb_fast, utils.rs:367-410)."""
        return curve.g1_lincomb_pippenger(settings.g1_values, scalars)

    def g1_lincomb(self, points, scalars):
        """Runtime-base lincomb (reference: g1_lincomb_naive, utils.rs:329)."""
        return hostcrypto.g1_lincomb_naive(points, scalars)

    def g1_mul(self, p, k):
        return hostcrypto.g1_mul(p, k)

    def g1_sub(self, p, q):
        return hostcrypto.g1_sub(p, q)

    def g1_add(self, p, q):
        return hostcrypto.g1_add(p, q)

    def g2_mul(self, p, k):
        return hostcrypto.g2_mul(p, k)

    def g2_sub(self, p, q):
        return hostcrypto.g2_sub(p, q)

    def pairings_verify(self, a1, a2, b1, b2) -> bool:
        return hostcrypto.pairings_verify(a1, a2, b1, b2)
