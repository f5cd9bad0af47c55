"""Signed-window recoding and the window-point select (device path).

The subset of the JAX package's ``ops/msm.py`` that batch verification
needs: the generator multiple of stage 2 (``verify_kernels.gen_mult``) is
one fixed-base multiply through a ``[64, 8, 1, 3, 12]`` window table of the
G1 generator, selected by signed base-16 digits.  The GLV-halved affine MSM
tables of the prover are a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from . import limbs as L
from .limbs import FP

WINDOW_BITS = 4
NUM_WINDOWS = 64  # ceil(255 / 4)
NUM_MULTIPLES = 8  # signed digits: |d| in 1..8


def recode_signed_digits(scalars, n: int) -> np.ndarray:
    """List of ints (mod r) -> [64, n] int8 signed base-16 digits.

    Standard signed-window recoding: nibble + carry, values > 8 borrow from
    the next window.  Scalars are < r < 2^255, so the top nibble is <= 7 and
    the final carry is absorbed (top digit <= 8), never emitted.
    """
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    by = np.frombuffer(buf, dtype=np.uint8).reshape(n, 32)
    return recode_signed_digits_le_bytes(by)


def recode_signed_digits_le_bytes(by: np.ndarray) -> np.ndarray:
    """[n, 32] little-endian scalar bytes -> [64, n] int8 signed digits.
    Byte-matrix entry point so bulk callers skip the python-int round trip."""
    n = by.shape[0]
    nib = np.zeros((n, NUM_WINDOWS), dtype=np.int16)
    nib[:, 0::2] = by & 0xF
    nib[:, 1::2] = by >> 4
    digits = np.zeros((n, NUM_WINDOWS), dtype=np.int8)
    carry = np.zeros(n, dtype=np.int16)
    for j in range(NUM_WINDOWS):
        d = nib[:, j] + carry
        over = (d > 8).astype(np.int16)
        carry = over
        digits[:, j] = (d - 16 * over).astype(np.int8)
    assert not carry.any(), "scalar exceeded 255 bits"
    return np.ascontiguousarray(digits.T)  # [64, n]


def select_window_points(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Gather the digit-selected multiple per (window, point) from a
    ``[W, 8, N, 3, 12]`` table: digit 0 -> projective infinity (0, Y, 0 -
    both X and Z must be zeroed for the complete-add formulas; table Y is
    never zero), negative digit -> negated Y.  Returns [W, N, 3, 12]."""
    digits = digits.to(device=table.device, dtype=torch.int64)
    mag = digits.abs()  # [W, N]
    w, _, n = table.shape[:3]
    idx = (mag - 1).clamp(min=0)[:, None, :, None, None].expand(w, 1, n, 3, FP.nwords)
    sel = torch.gather(table, 1, idx)[:, 0]
    zmask = (mag == 0)[..., None]
    x = torch.where(zmask, 0, sel[..., 0, :])
    z = torch.where(zmask, 0, sel[..., 2, :])
    y = torch.where((digits < 0)[..., None], L.neg_mod(FP, sel[..., 1, :]), sel[..., 1, :])
    return torch.stack([x, y, z], dim=-2)
