"""Per-settings Fr state for the polynomial kernels (device path).

The subset of the JAX package's ``ops/protocol_kernels.py`` that batch
verification needs: :class:`FrContext`.  The quotient and single-blob
barycentric kernels belong to the prover slice.
"""

from __future__ import annotations

import torch

from ..golden.field import R
from . import limbs as L
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
        n = settings.preset.field_elements_per_blob
        rr = FR.mont_r
        roots = settings.roots_of_unity
        return cls(
            n,
            L.to_device(FR, [w * rr % R for w in roots], device),
            L.to_device(FR, [w * rr * rr % R for w in roots], device),
            L.to_device(FR, [pow(n, -1, R) * rr % R], device)[0],
        )
