"""Fr-vector protocol math on the device: per-settings state, the
single-blob barycentric evaluation and the two quotients.

Counterpart of the JAX package's ``ops/protocol_kernels.py``: the
4096-wide polynomial math the reference runs as scalar loops (reference:
src/kzg.rs:346-389 barycentric evaluation; :468-523 quotient construction)
as launch sequences of K2 and the Fr launchers.  Inputs and outputs are
canonical Fr word tensors; the prover and the backend convert.
"""

from __future__ import annotations

import torch

from ..golden.field import R
from . import limbs as L
from . import verify_kernels as V
from .limbs import FR


class FrContext:
    """The bit-reversed roots of unity as Fr word tensors, plus width
    constants, rebuilt for the port's Fr radix R = 2^256.

    ``roots_m2`` carries ``w * R^2``: multiplying CANONICAL evaluations by it
    through two Montgomery products lands directly on ``(e * v) * R``, which
    saves a full-width ``to_mont(evals)`` in the barycentric evaluation."""

    def __init__(self, n: int, roots_m, roots_m2, inv_n_m):
        self.n = n
        self.roots_m = roots_m  # [n, 8] Montgomery form (w R)
        self.roots_m2 = roots_m2  # [n, 8] w R^2
        self.inv_n_m = inv_n_m  # [8] mont(1/n)

    @classmethod
    def build(cls, settings, device) -> "FrContext":
        return cls.from_roots(settings.preset.field_elements_per_blob, settings.roots_of_unity, device)

    @classmethod
    def from_roots(cls, n: int, roots, device) -> "FrContext":
        """The context of ``roots`` (the whole domain of size n, or a shard's
        slice of it), with the whole domain's n and mont(1/n)."""
        rr = FR.mont_r
        return cls(
            n,
            L.to_device(FR, [w * rr % R for w in roots], device),
            L.to_device(FR, [w * rr * rr % R for w in roots], device),
            L.to_device(FR, [pow(n, -1, R) * rr % R], device)[0],
        )


def barycentric_eval_inv(ctx: FrContext, evals: torch.Tensor, x: torch.Tensor):
    """p(x) for one blob: evals [n, 8], x [8] canonical, x out of the
    domain -> (y [8] canonical, inv [n, 8] = mont(1 / (x - w_i))).  The
    batched evaluation of verification with B = 1 (the JAX package's
    ``_bary_kernel``)."""
    y, inv = V.bary_batch_inv(ctx, evals[:, None], x[None])
    return y[0], inv[:, 0]


def barycentric_eval(ctx: FrContext, evals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return barycentric_eval_inv(ctx, evals, x)[0]


def quotient_out_of_domain(ctx: FrContext, evals, z, y, inv=None) -> torch.Tensor:
    """q_i = (e_i - y) / (w_i - z) (reference: kzg.rs:468-491), canonical
    [n, 8] from canonical evals [n, 8], z and y [8].  ``inv``, the inverses
    mont(1 / (z - w_i)) that the barycentric evaluation of y at z already
    made, turns the inversion into one negation, 1 / (w - z) = -1 / (z - w)
    (the JAX proof kernel's trick, ``prover_kernels.py:85-92``); without it
    the inverses of w_i - z are made here."""
    if inv is None:
        d = L.sub_mod(FR, ctx.roots_m, L.to_mont(FR, z)[None])
        inv_wz = L.batch_mont_inv(FR, d)
    else:
        inv_wz = L.neg_mod(FR, inv)
    # canonical x Montgomery -> canonical
    return L.mont_mul(FR, L.sub_mod(FR, evals, y[None]), inv_wz)


def quotient_in_domain(ctx: FrContext, evals, z, y, m: int) -> torch.Tensor:
    """z == w_m: q_i = (e_i - y) / (w_i - z) for i != m, and
    q_m = sum_{i != m} (e_i - y) w_i / (z (z - w_i)) (reference:
    kzg.rs:471-523).  The host knows m, so the special row is an index, not
    the JAX kernel's masked select; the values are the same."""
    one_m = FR.const("one_mont", evals.device)
    z_m = L.to_mont(FR, z)[None]
    e_minus_y = L.sub_mod(FR, evals, y[None])  # canonical
    den1 = L.sub_mod(FR, ctx.roots_m, z_m)
    den1[m] = one_m
    q = L.mont_mul(FR, e_minus_y, L.batch_mont_inv(FR, den1))
    den2 = L.mont_mul(FR, L.sub_mod(FR, z_m, ctx.roots_m), z_m)
    den2[m] = one_m
    terms = L.mont_mul(FR, L.mont_mul(FR, e_minus_y, ctx.roots_m), L.batch_mont_inv(FR, den2))
    terms[m] = 0
    q[m] = L.sum_mod(FR, terms)
    return q
