"""The JAX package's device state, carried into the port's layout.

The JAX package holds field elements as 12-bit limbs in ``uint32`` lanes:
Fp ``[..., 32]`` with Montgomery radix 2^384, Fr ``[..., 22]`` with radix
2^264.  These functions take such arrays as numpy (no JAX is imported) and
return the port's int32 word tensors.  Fp values keep their integer, since
the two packages share the Fp radix; Fr values in Montgomery form are
re-radixed from 2^264 to the port's 2^256 (multiplied by 2^-8 mod r).
Tests use them to feed the JAX package's own tensors through the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.field import R
from . import limbs as L
from .limbs import FP, FR

JAX_LIMB_BITS = 12
_FR_RERADIX = pow(2, -(264 - 256), R)  # 2^264 -> 2^256


def limbs12_to_ints(arr) -> list[int]:
    """[..., n] 12-bit limbs (numpy) -> python ints, flattened."""
    arr = np.asarray(arr, dtype=np.uint64)
    flat = arr.reshape(-1, arr.shape[-1])
    weights = [1 << (JAX_LIMB_BITS * k) for k in range(flat.shape[1])]
    return [sum(int(v) * w for v, w in zip(row, weights)) for row in flat.tolist()]


def _to_words(spec, values, lead_shape, device) -> torch.Tensor:
    words = L.ints_to_words(spec.nwords, values).reshape(tuple(lead_shape) + (spec.nwords,))
    return torch.from_numpy(words).to(device)


def fp_from_jax(arr, device="cpu") -> torch.Tensor:
    """Fp ``[..., 32]`` limbs, canonical or Montgomery -> ``[..., 12]``."""
    arr = np.asarray(arr)
    return _to_words(FP, limbs12_to_ints(arr), arr.shape[:-1], device)


def fr_from_jax(arr, mont: bool = False, device="cpu") -> torch.Tensor:
    """Fr ``[..., 22]`` limbs -> ``[..., 8]``; ``mont=True`` re-radixes a
    Montgomery value from 2^264 to 2^256."""
    arr = np.asarray(arr)
    vals = limbs12_to_ints(arr)
    if mont:
        vals = [v * _FR_RERADIX % R for v in vals]
    return _to_words(FR, vals, arr.shape[:-1], device)


def fp2_from_jax(x, device="cpu"):
    """An Fp2 of the JAX tower, (c0, c1) of ``[..., 32]`` limbs -> (c0, c1)
    of ``[..., 12]`` words (Montgomery values keep their integers)."""
    return tuple(fp_from_jax(c, device) for c in x)


def fp6_from_jax(x, device="cpu"):
    return tuple(fp2_from_jax(c, device) for c in x)


def fp12_from_jax(x, device="cpu"):
    return tuple(fp6_from_jax(c, device) for c in x)


def points_from_jax(arr, device="cpu") -> torch.Tensor:
    """Projective points ``[..., 3, 32]`` -> ``[..., 3, 12]``."""
    return fp_from_jax(arr, device)


def fr_context_from_jax(n: int, roots_m, roots_m2, inv_n_m, device="cpu"):
    """An :class:`~.protocol_kernels.FrContext` from the JAX package's
    ``roots_m`` (w 2^264), ``roots_m2`` (w 2^528) and ``inv_n_m``."""
    from .protocol_kernels import FrContext

    roots_m = np.asarray(roots_m)
    m2 = [v * _FR_RERADIX * _FR_RERADIX % R for v in limbs12_to_ints(roots_m2)]
    return FrContext(
        n,
        fr_from_jax(roots_m, mont=True, device=device),
        _to_words(FR, m2, roots_m.shape[:-1], device),
        fr_from_jax(inv_n_m, mont=True, device=device),
    )


def gen_table_from_jax(table, device="cpu") -> torch.Tensor:
    """The generator window table ``[64, 8, 1, 3, 32]`` -> ``[64, 8, 1, 3, 12]``."""
    return points_from_jax(table, device)


def msm_context_from_jax(table, inf_mask, device="cpu"):
    """A :class:`~.msm.MsmContext` from the JAX package's GLV table
    ``[26, 16, N, 2, 32]`` (affine Montgomery Fp, the same integers in both
    packages) and ``inf_mask`` [N], with the port's M2 configuration."""
    from .msm import MsmContext, msm_config

    inf = torch.from_numpy(np.asarray(inf_mask, dtype=bool).copy()).to(device)
    n = inf.shape[0]
    return MsmContext(n, fp_from_jax(table, device), inf, msm_config(n, device))
