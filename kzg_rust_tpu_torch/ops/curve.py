"""Complete BLS12-381 G1 arithmetic on word tensors (device path).

Counterpart of the JAX package's ``ops/curve.py``.  A point batch is one
int32 tensor ``[..., 3, 12]`` of homogeneous projective (X, Y, Z) in Fp
Montgomery form (x = X/Z, y = Y/Z); the point at infinity is
(0, mont(1), 0).  Addition and doubling are the exception-free formulas of
Renes, Costello and Batina (eprint 2015/1060, algorithms 7 and 9, a = 0):
complete on every input, so a batch needs no masks.

On CUDA tensors :func:`proj_add` launches K3 (``csrc/curve_kernels.cu``
``kzg_proj_add``, replacing the JAX package's ``pallas_kernels.py:348``
``proj_add_pallas``) and :func:`proj_double` K4 (``kzg_proj_double``,
replacing ``:354`` ``proj_double_pallas``); :func:`proj_double_chain` runs
K4 ``steps`` times in one launch (``kzg_proj_double_chain``), and
:func:`proj_add_mixed` runs the complete mixed add (RCB algorithm 8, an
affine second operand) of the MSM kernel M2 alone (``csrc/msm_kernels.cu``
``kzg_proj_add_mixed``), or they raise; on CPU tensors they run the plain
versions below, which follow the same operation order over the plain field
functions.  All give the same canonical coordinates as the JAX package's
``curve.proj_add`` / ``proj_double`` / ``proj_add_mixed``.
"""

from __future__ import annotations

import torch

from ..golden.field import P
from . import _build
from . import limbs as L
from .limbs import FP

# Launch counts of K3 (``kzg_proj_add``) and K4 (``kzg_proj_double``,
# ``kzg_proj_double_chain``): plain ints that _build.launch adds one to at
# each launch (shared with limbs.py).
LAUNCHES = _build.LAUNCHES

# b3 = 3 * b = 12 for y^2 = x^3 + 4, and the GLV constant beta (a primitive
# cube root of unity in Fp, phi(x, y) = (beta x, y)), in Montgomery form.
B3_MONT = 12 * FP.mont_r % P
BETA_MONT = pow(2, (P - 1) // 3, P) * FP.mont_r % P


# ---------------------------------------------------------------------------
# Host codecs: golden affine int points <-> projective Montgomery words
# ---------------------------------------------------------------------------


def points_to_proj(points, device="cpu") -> torch.Tensor:
    """Golden affine points ((x, y) ints, None == infinity) ->
    ``[N, 3, 12]`` int32 projective Montgomery words on ``device``."""
    rr = FP.mont_r
    vals = []
    for p in points:
        if p is None:
            vals += [0, rr, 0]
        else:
            vals += [p[0] * rr % P, p[1] * rr % P, rr]
    arr = L.ints_to_words(FP.nwords, vals).reshape(len(points), 3, FP.nwords)
    return torch.from_numpy(arr).to(device)


def proj_to_points(arr, mont: bool = True) -> list:
    """``[N, 3, 12]`` projective words -> golden affine points (None ==
    infinity), on the host with plain bigint inversions (small outputs)."""
    vals = L.words_to_ints(torch.as_tensor(arr).reshape(-1, FP.nwords))
    rinv = pow(FP.mont_r, -1, P) if mont else 1
    out = []
    for i in range(0, len(vals), 3):
        x, y, z = (v * rinv % P for v in vals[i : i + 3])
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, P)
        out.append((x * zinv % P, y * zinv % P))
    return out


# ---------------------------------------------------------------------------
# Point ops
# ---------------------------------------------------------------------------


def point_is_inf(p):
    return L.is_zero(p[..., 2, :])


def point_neg(p):
    y = L.neg_mod(FP, p[..., 1, :])
    return torch.stack([p[..., 0, :], y, p[..., 2, :]], dim=-2)


def proj_add_plain(p, q):
    """Plain version of K3: RCB algorithm 7 (a = 0), 12 products plus two
    by b3, in curve.py's order."""
    x1, y1, z1 = p.unbind(-2)
    x2, y2, z2 = q.unbind(-2)
    mul = lambda u, v: L.mont_mul_plain(FP, u, v)  # noqa: E731
    add = lambda u, v: L.add_mod_plain(FP, u, v)  # noqa: E731
    sub = lambda u, v: L.sub_mod_plain(FP, u, v)  # noqa: E731
    b3 = FP.const(B3_MONT, p.device)

    t0 = mul(x1, x2)
    t1 = mul(y1, y2)
    t2 = mul(z1, z2)
    t3 = sub(mul(add(x1, y1), add(x2, y2)), add(t0, t1))  # X1Y2 + X2Y1
    t4 = sub(mul(add(y1, z1), add(y2, z2)), add(t1, t2))  # Y1Z2 + Y2Z1
    t5 = sub(mul(add(x1, z1), add(x2, z2)), add(t0, t2))  # X1Z2 + X2Z1
    three_t0 = add(add(t0, t0), t0)
    bt2 = mul(b3, t2)
    z3t = add(t1, bt2)
    t1m = sub(t1, bt2)
    y3t = mul(b3, t5)
    x3 = sub(mul(t3, t1m), mul(t4, y3t))
    y3 = add(mul(y3t, three_t0), mul(t1m, z3t))
    z3 = add(mul(z3t, t4), mul(three_t0, t3))
    return torch.stack([x3, y3, z3], dim=-2)


def proj_add_mixed_plain(p, q):
    """Plain version of the mixed add of M2 (``csrc/curve.cuh`` add_mixed):
    RCB algorithm 8 (a = 0), 11 products plus two by b3, in curve.py's
    order.  ``q`` is ``[..., 2, 12]`` affine (X2, Y2), Z2 = 1, and must not
    be the point at infinity; ``p`` may be."""
    x1, y1, z1 = p.unbind(-2)
    x2, y2 = q.unbind(-2)
    mul = lambda u, v: L.mont_mul_plain(FP, u, v)  # noqa: E731
    add = lambda u, v: L.add_mod_plain(FP, u, v)  # noqa: E731
    sub = lambda u, v: L.sub_mod_plain(FP, u, v)  # noqa: E731
    b3 = FP.const(B3_MONT, p.device)

    t0 = mul(x1, x2)
    t1 = mul(y1, y2)
    t3 = sub(mul(add(x1, y1), add(x2, y2)), add(t0, t1))
    t4 = add(mul(y2, z1), y1)  # Y1 + Y2 Z1
    t5 = add(mul(x2, z1), x1)  # X1 + X2 Z1
    three_t0 = add(add(t0, t0), t0)
    bt2 = mul(b3, z1)
    z3t = add(t1, bt2)
    t1m = sub(t1, bt2)
    y3t = mul(b3, t5)
    x3 = sub(mul(t3, t1m), mul(t4, y3t))
    y3 = add(mul(y3t, three_t0), mul(t1m, z3t))
    z3 = add(mul(z3t, t4), mul(three_t0, t3))
    return torch.stack([x3, y3, z3], dim=-2)


def proj_double_plain(p):
    """Plain version of K4: RCB algorithm 9 (a = 0), 8 products plus one
    by b3, in curve.py's order."""
    x, y, z = p.unbind(-2)
    mul = lambda u, v: L.mont_mul_plain(FP, u, v)  # noqa: E731
    add = lambda u, v: L.add_mod_plain(FP, u, v)  # noqa: E731
    sub = lambda u, v: L.sub_mod_plain(FP, u, v)  # noqa: E731
    b3 = FP.const(B3_MONT, p.device)

    t0 = mul(y, y)
    t00 = add(t0, t0)
    t0000 = add(t00, t00)
    z3 = add(t0000, t0000)  # 8 Y^2
    t1 = mul(y, z)
    t2 = mul(b3, mul(z, z))
    x3 = mul(t2, z3)
    y3 = add(t0, t2)
    z3 = mul(t1, z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    t0 = sub(t0, t2)
    y3 = add(x3, mul(t0, y3))
    x3 = mul(t0, mul(x, y))
    x3 = add(x3, x3)
    return torch.stack([x3, y3, z3], dim=-2)


def proj_double_chain_plain(p, steps: int):
    """Plain version of the K4 chain: ``[steps, *p.shape]`` with
    ``out[k] = 2^(k+1) P``, iterated :func:`proj_double_plain`."""
    out = []
    for _ in range(steps):
        p = proj_double_plain(p)
        out.append(p)
    return torch.stack(out)


def _check_points(*ps):
    for p in ps:
        if p.dtype != torch.int32 or p.shape[-2:] != (3, FP.nwords):
            raise ValueError(f"expected int32 [..., 3, {FP.nwords}] points, got {p.dtype} {tuple(p.shape)}")
        if p.shape != ps[0].shape or p.device != ps[0].device:
            raise ValueError("point operands differ in shape or device")


def _out(p, out, shape=None):
    shape = p.shape if shape is None else shape
    if out is None:
        return torch.empty(shape, dtype=p.dtype, device=p.device)
    if out.shape != shape or out.dtype != p.dtype or out.device != p.device:
        raise ValueError(f"out must be {p.dtype} {tuple(shape)} on {p.device}, got {out.dtype} {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    return out


def proj_add(p, q, out=None):
    """Complete projective addition of two point batches of one shape,
    written into ``out`` when given."""
    _check_points(p, q)
    if p.device.type == "cpu":
        r = proj_add_plain(p, q)
        return r if out is None else out.copy_(r)
    out = _out(p, out)
    n = p.numel() // (3 * FP.nwords)
    if n:
        _build.launch("kzg_proj_add", p.device, p.contiguous(), q.contiguous(), out, n)
    return out


def proj_add_mixed(p, q):
    """Complete mixed addition of ``[..., 3, 12]`` projective points and
    ``[..., 2, 12]`` affine points (never infinity) of one batch shape: the
    add of M2 alone (``kzg_proj_add_mixed``)."""
    _check_points(p)
    if q.dtype != torch.int32 or q.shape != p.shape[:-2] + (2, FP.nwords) or q.device != p.device:
        raise ValueError(f"expected int32 {tuple(p.shape[:-2]) + (2, FP.nwords)} affine points on {p.device}")
    if p.device.type == "cpu":
        return proj_add_mixed_plain(p, q)
    out = _out(p, None)
    n = p.numel() // (3 * FP.nwords)
    if n:
        _build.launch("kzg_proj_add_mixed", p.device, p.contiguous(), q.contiguous(), out, n)
    return out


def proj_double(p, out=None):
    """Complete projective doubling, written into ``out`` when given."""
    _check_points(p)
    if p.device.type == "cpu":
        r = proj_double_plain(p)
        return r if out is None else out.copy_(r)
    out = _out(p, out)
    n = p.numel() // (3 * FP.nwords)
    if n:
        _build.launch("kzg_proj_double", p.device, p.contiguous(), out, n)
    return out


def proj_double_chain(p, steps: int, out=None):
    """``steps`` doublings in one launch: ``[steps, *p.shape]`` with
    ``out[k] = 2^(k+1) P``, written into ``out`` when given."""
    _check_points(p)
    shape = (steps,) + tuple(p.shape)
    if p.device.type == "cpu":
        r = proj_double_chain_plain(p, steps)
        return r if out is None else out.copy_(r)
    out = _out(p, out, shape)
    n = p.numel() // (3 * FP.nwords)
    if n and steps:
        _build.launch("kzg_proj_double_chain", p.device, p.contiguous(), out, n, steps)
    return out


def sum_points(points, add=None):
    """Sum ``[W, ..., 3, 12]`` points over axis 0 as a halving tree: each
    level adds the first half to the second (contiguous slices) and an odd
    width carries its last row to the next level, W - 1 adds in
    ceil(log2 W) calls of ``add`` (K3, :func:`proj_add`, by default).
    Serves both of the JAX package's reductions, ``curve.fold_reduce`` (a
    TPU compile-size device: one scan plus a fixed-width ladder) and
    ``verify_kernels._reduce_axis0`` (this same tree, whose order it keeps);
    M2's trees (``csrc/msm_kernels.cu``) keep it too."""
    add = add or proj_add
    while points.shape[0] > 1:
        h = points.shape[0] // 2
        red = add(points[:h], points[h : 2 * h])
        if points.shape[0] % 2:
            red = torch.cat([red, points[2 * h :]])
        points = red
    return points[0]
