"""GLV scalar decomposition for BLS12-381 G1 (host-side recoding).

The verification lincombs multiply *runtime* points (commitments, proofs) by
255-bit scalars (reference: src/kzg.rs:601-616, src/utils.rs:329-342).  On
TPU the cost of a runtime-point multi-scalar multiply is dominated by the
strictly sequential doubling chain that builds the window bases ``4^j * P``;
its depth equals the scalar bit-length.  BLS12-381's G1 carries the cube-root
endomorphism ``phi(x, y) = (beta * x, y) = [lam] (x, y)`` with
``lam = r - z^2`` (z the BLS parameter), which lets every scalar split as

    k = k1 + k2 * lam  (mod r),   |k1|, |k2| < 2^128

halving the chain depth: ``k * P = k1 * P + k2 * phi(P)`` and the bases of
``phi(P)`` are just the bases of ``P`` with X scaled by beta (phi commutes
with doubling).  The split is exact integer lattice reduction - the outputs
recombine to k mod r bit-exactly, so protocol results are unchanged.

Everything here is host-side numpy/int math on tiny inputs (a few hundred
scalars per batch); the heavy lifting stays in the device kernels.
"""

from __future__ import annotations

import numpy as np

from ..golden.field import R

# BLS parameter z (the Miller-loop constant is -z; z itself is positive here).
Z_BLS = 0xD201000000010000
Z2 = Z_BLS * Z_BLS
# Eigenvalue of phi: lam = -z^2 mod r (see golden/curve.py g1_in_subgroup;
# (z^2)^2 - z^2 + 1 == r so lam^2 + lam + 1 == 0 mod r).
LAM = R - Z2

# Lattice basis for {(a, b) : a + b*lam == 0 mod r}:
#   v1 = (z^2, 1)       since z^2 + lam == 0 (mod r)
#   v2 = (-1, z^2 - 1)  since -1 + (z^2-1)*lam == -r == 0 (mod r)
# det(v1, v2) = z^2(z^2-1) + 1 = r.
assert (Z2 + LAM) % R == 0
assert (-1 + (Z2 - 1) * LAM) % R == 0

WINDOW_BITS = 2
# |k1|,|k2| <= ~2^127.5; 65 base-4 digits cover 130 bits, +1 for the signed
# recoding carry.
NUM_WINDOWS_GLV = 66

# Base-32 recoding (the fixed-base MSM tables): 26 signed 5-bit windows
# cover 130 bits, enough for |k| < 2^128 plus the approximate-rounding slack
# of the on-device decomposition below.
WINDOW_BITS_32 = 5
NUM_WINDOWS_GLV32 = 26

# On-device decomposition constants (used by ops.msm.glv_digits_from_limbs):
# Babai rounding with the divisions replaced by one multiply-high each.
#   m1 ~= k (z^2 - 1) / r  via  floor(k * G1C / 2^SHIFT)
#   m2' = round(k / r)     ==   1 iff 2k >= r (k is canonical, < r)
# G1C = round((z^2 - 1) 2^SHIFT / r); with SHIFT = 264 (one full Fr limb
# vector), m1 = floor(k*G1C/2^264).  Writing the exact Babai coefficients
# c1 = k(z^2-1)/r, c2 = -k/r, the halves are k1 = e1*z^2 - e2 and
# k2 = e2*(z^2-1) + e1 with e1 = c1 - m1 and e2 = c2 + m2'.  The floor
# contributes e1 in [0, 1) and the G1C quantization adds at most
# k/2^265 < 2^-10, so e1 in (-2^-10, 1 + 2^-10); m2' = round(k/r) gives
# e2 in (-1/2, 1/2].  Hence |k1| < 1.001*z^2 + 1/2 < 2^128 (z^2 < 2^127.5;
# numerically verified worst case |k1| ~ 1.0005*z^2) and |k2| < 2^127.5 —
# both 2 bits inside the 26-digit base-32 recoding capacity (|k| < 2^130),
# and the decomposition is exact for ANY integer m1, m2 (see decompose()).
DECOMP_SHIFT = 264
G1C = ((Z2 - 1) * (1 << DECOMP_SHIFT) + R // 2) // R
HALF_R_CEIL = (R + 1) // 2


def decompose(k: int) -> tuple[int, int]:
    """k (canonical mod r) -> (k1, k2) signed ints with k1 + k2*lam == k
    (mod r) and |k1|, |k2| < 2^128 (standard Babai rounding on the lattice
    basis above)."""
    k = k % R
    # (k, 0) = c1*v1 + c2*v2 over Q, with c1 = k(z^2-1)/r, c2 = -k/r.
    m1 = (k * (Z2 - 1) + R // 2) // R
    m2 = -((k + R // 2) // R)
    k1 = k - m1 * Z2 + m2
    k2 = -m1 - m2 * (Z2 - 1)
    return k1, k2


def decompose_batch(scalars) -> tuple[list[int], list[int]]:
    k1s, k2s = [], []
    for s in scalars:
        a, b = decompose(int(s))
        k1s.append(a)
        k2s.append(b)
    return k1s, k2s


def recode_base4_signed(scalars) -> np.ndarray:
    """Signed ints |k| < 2^130 -> [NUM_WINDOWS_GLV, n] int8 digits in
    {-2,-1,0,1,2} with  k = sum_j d_j * 4^j  exactly.

    Standard signed-window recoding on |k| (digit > 2 borrows from the next
    window), then the global sign folds into the digits.
    """
    n = len(scalars)
    signs = np.array([1 if int(s) >= 0 else -1 for s in scalars], dtype=np.int16)
    mags = [abs(int(s)) for s in scalars]
    buf = b"".join(m.to_bytes(17, "little") for m in mags)  # 136 bits >= 132
    by = np.frombuffer(buf, dtype=np.uint8).reshape(n, 17)
    # 4 base-4 digits per byte.
    dig = np.zeros((n, 68), dtype=np.int16)
    for p in range(4):
        dig[:, p::4] = (by >> (2 * p)) & 0x3
    dig = dig[:, :NUM_WINDOWS_GLV]
    if np.any(dig[:, NUM_WINDOWS_GLV - 2 :] > 2):  # pragma: no cover - bound
        raise ValueError("scalar exceeds the GLV recoding range")
    out = np.zeros((n, NUM_WINDOWS_GLV), dtype=np.int8)
    carry = np.zeros(n, dtype=np.int16)
    for j in range(NUM_WINDOWS_GLV):
        d = dig[:, j] + carry
        over = (d > 2).astype(np.int16)
        carry = over
        out[:, j] = (d - 4 * over).astype(np.int8)
    if carry.any():  # pragma: no cover - |k| < 4^65 guarantees absorption
        raise ValueError("recoding carry out of range")
    out *= signs[:, None].astype(np.int8)
    return np.ascontiguousarray(out.T)  # [66, n]


def recode_base32_signed(scalars) -> np.ndarray:
    """Signed ints |k| < 2^129 -> [NUM_WINDOWS_GLV32, n] int8 digits in
    {-16..16} with  k = sum_j d_j * 32^j  exactly.

    Same structure as :func:`recode_base4_signed` with 5-bit windows: the
    magnitude's raw base-32 digits (extracted across byte boundaries), a
    signed-recoding carry pass (digit > 16 borrows from the next window),
    then the global sign folded into the digits.
    """
    n = len(scalars)
    signs = np.array([1 if int(s) >= 0 else -1 for s in scalars], dtype=np.int8)
    mags = [abs(int(s)) for s in scalars]
    buf = b"".join(m.to_bytes(17, "little") for m in mags)  # 136 bits >= 130
    by = np.frombuffer(buf, dtype=np.uint8).reshape(n, 17).astype(np.uint16)
    by = np.concatenate([by, np.zeros((n, 1), np.uint16)], axis=1)
    dig = np.zeros((n, NUM_WINDOWS_GLV32), dtype=np.int16)
    for j in range(NUM_WINDOWS_GLV32):
        bit = WINDOW_BITS_32 * j
        b0, off = bit // 8, bit % 8
        dig[:, j] = ((by[:, b0] | (by[:, b0 + 1] << 8)) >> off) & 31
    out = np.zeros((n, NUM_WINDOWS_GLV32), dtype=np.int8)
    carry = np.zeros(n, dtype=np.int16)
    for j in range(NUM_WINDOWS_GLV32):
        d = dig[:, j] + carry
        over = (d > 16).astype(np.int16)
        carry = over
        out[:, j] = (d - 32 * over).astype(np.int8)
    if carry.any():  # pragma: no cover - |k| < 2^129 guarantees absorption
        raise ValueError("recoding carry out of range")
    out *= signs[:, None]
    return np.ascontiguousarray(out.T)  # [26, n]


