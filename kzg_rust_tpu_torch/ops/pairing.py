"""The device pairing: the Miller loop and the final exponentiation.

Counterpart of the JAX package's ``ops/pairing.py`` (the blst pairing
surface behind the reference's ``pairings_verify``, utils.rs:189-214), over
:mod:`.tower`:

* T is homogeneous projective over Fp2 with the exception-free RCB
  formulas (b3 = 3 * 4 (1 + u) = 12 + 12u on the twist), and every line is
  scaled by its denominator, 2 Y Z^2 for a tangent and x2 Z - X for a chord:
  Fp2 factors that the final exponentiation annihilates, so no inversion
  appears in the loop.  Those scales make the Miller value itself, not only
  the final flag, the JAX program's.
* The pair axis is the first axis and any further axes batch.  A lane with
  an infinity argument (``active`` False) yields one.
* The final exponentiation is the golden model's cubed x-chain, its five
  exponentiations by x as square-and-multiply with Granger-Scott
  squarings, and one Fp Fermat inversion in the easy part.

Three hand-written kernels run it on the card (``csrc/pairing_kernels.cu``
over ``csrc/tower.cuh``): P2 ``kzg_miller_loop`` (:func:`miller_loop`, the
JAX ``miller_loop_kernel``), P3 ``kzg_final_exp`` (:func:`final_exp`, the
easy part, the hard chain and the tail), and P1 ``kzg_fp12_op``
(:func:`.tower.fp12_op`, one Fp12 function at a time).  Each gives a
Miller lane, check or element a group of G lanes with its state in shared
memory, and runs the programs of :mod:`.pairing_programs`: each step's
independent Fp products side by side over the group's lanes (G by width,
``tower.pairing_group``).  The bits of |x| are public, so the kernels and
the plain versions branch on them where the JAX programs compute both
outcomes and select: the same function.

On a CPU tensor each wrapper runs its plain version (the packed tower over
the plain Fp operations, ``tower.PLAIN``); on a CUDA tensor it launches its
kernel or raises.  :func:`pairings_verify_device` is the op-level drop-in
for ``golden.pairing.pairings_verify``; no backend calls it (the backends'
pairing is the host engine's, as in the JAX package).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..golden.field import BLS_X
from . import _build
from . import tower as T2
from .limbs import FP

NW = FP.nwords
# Bits of |x| below its MSB, MSB first: the Miller loop's and the
# exponentiations' (kzg_miller_loop has them in its source, kzg_final_exp
# takes them as an argument).
_X_BITS = [(BLS_X >> i) & 1 for i in range(BLS_X.bit_length() - 2, -1, -1)]
_ABS_X_BITS = tuple(_X_BITS)


_st = T2._stack


def _c(x, k):
    """Fp2 coefficient k of a packed [..., m, 2, 12] tuple of Fp2 values."""
    return x[..., k, :, :]


# ---------------------------------------------------------------------------
# G2 projective steps and lines on packed values, over a tower
# (T [..., 3, 2, 12] = X, Y, Z; q [..., 2, 2, 12] = x2, y2; a line
# [..., 3, 2, 12] = c00, c11, c12)
# ---------------------------------------------------------------------------


def _double(tw, t):
    """RCB doubling (the JAX ``_g2_double``)."""
    x, y, z = _c(t, 0), _c(t, 1), _c(t, 2)
    p = tw.f2_mul(_st([y, y, z, x], -3), _st([y, z, z, y], -3))
    t0, t1, zz, xy = (_c(p, k) for k in range(4))
    t2 = tw.f2_mul(T2._const("b3", t.device), zz)
    z3 = tw.add(t0, t0)
    z3 = tw.add(z3, z3)
    z3 = tw.add(z3, z3)  # 8 Y^2
    y3 = tw.add(t0, t2)
    t0 = tw.sub(t0, tw.add(tw.add(t2, t2), t2))
    r = tw.f2_mul(_st([t2, t1, t0, t0], -3), _st([z3, z3, y3, xy], -3))
    x3 = tw.add(_c(r, 3), _c(r, 3))
    return _st([x3, tw.add(_c(r, 0), _c(r, 2)), _c(r, 1)], -3)


def _madd(tw, t, q):
    """t projective + q affine, q never infinity (the JAX ``_g2_madd``)."""
    x1, y1, z1 = _c(t, 0), _c(t, 1), _c(t, 2)
    x2, y2 = _c(q, 0), _c(q, 1)
    b3 = T2._const("b3", t.device)
    s = tw.add(_st([x1, x2], -3), _st([y1, y2], -3))
    p = tw.f2_mul(_st([x1, y1, _c(s, 0), y2, x2, b3], -3), _st([x2, y2, _c(s, 1), z1, z1, z1], -3))
    t0, t1, m, y2z1, x2z1, bt2 = (_c(p, k) for k in range(6))
    t3 = tw.sub(m, tw.add(t0, t1))
    t4 = tw.add(y2z1, y1)
    t5 = tw.add(x2z1, x1)
    three_t0 = tw.add(tw.add(t0, t0), t0)
    z3t = tw.add(t1, bt2)
    t1m = tw.sub(t1, bt2)
    y3t = tw.f2_mul(b3, t5)
    r = tw.f2_mul(_st([t3, t4, y3t, t1m, z3t, three_t0], -3), _st([t1m, y3t, three_t0, z3t, t4, t3], -3))
    return _st([tw.sub(_c(r, 0), _c(r, 1)), tw.add(_c(r, 2), _c(r, 3)), tw.add(_c(r, 4), _c(r, 5))], -3)


def _tangent(tw, t, xp, yp):
    """The tangent at t scaled by 2YZ^2: c00 = xi 2YZ^2 yP, c11 = 3X^3 -
    2Y^2 Z, c12 = -3X^2 Z xP (the JAX ``tangent_line_coeffs``)."""
    x, y, z = _c(t, 0), _c(t, 1), _c(t, 2)
    p = tw.f2_mul(_st([x, y, y], -3), _st([x, z, y], -3))
    xx, yz, yy = _c(p, 0), _c(p, 1), _c(p, 2)
    three_xx = tw.add(tw.add(xx, xx), xx)
    q = tw.f2_mul(_st([yz, three_xx, yy, three_xx], -3), _st([z, x, z, z], -3))
    yz2, xxx3, yyz, xxz3 = (_c(q, k) for k in range(4))
    s = tw.mul(_st([tw.f2_mul_xi(tw.add(yz2, yz2)), xxz3], -3), _st([yp, xp], -2).unsqueeze(-2))
    return _st([_c(s, 0), tw.sub(xxx3, tw.add(yyz, yyz)), tw.neg(_c(s, 1))], -3)


def _chord(tw, t, q, xp, yp):
    """The chord through t and q scaled by D = x2 Z - X: c00 = xi D yP,
    c11 = N x2 - y2 D, c12 = -N xP with N = y2 Z - Y (the JAX
    ``chord_line_coeffs``)."""
    x, y, z = _c(t, 0), _c(t, 1), _c(t, 2)
    x2, y2 = _c(q, 0), _c(q, 1)
    p = tw.f2_mul(_st([y2, x2], -3), _st([z, z], -3))
    nn, dd = tw.sub(_c(p, 0), y), tw.sub(_c(p, 1), x)
    r = tw.f2_mul(_st([nn, y2], -3), _st([x2, dd], -3))
    s = tw.mul(_st([tw.f2_mul_xi(dd), nn], -3), _st([yp, xp], -2).unsqueeze(-2))
    return _st([_c(s, 0), tw.sub(_c(r, 0), _c(r, 1)), tw.neg(_c(s, 1))], -3)


def _step(tw, f, t, q, xp, yp):
    """(f_dbl, t_dbl, f_add, t_add): the square, tangent line and doubling,
    then the chord line and mixed add on top (the JAX ``miller_step``)."""
    f_dbl = tw.f12_mul_by_line(tw.f12_sqr(f), _tangent(tw, t, xp, yp))
    t_dbl = _double(tw, t)
    f_add = tw.f12_mul_by_line(f_dbl, _chord(tw, t_dbl, q, xp, yp))
    return f_dbl, t_dbl, f_add, _madd(tw, t_dbl, q)


def _one12(shape, device):
    return T2._const("one12", device).expand(tuple(shape) + T2.FP12_SHAPE)


def _miller(tw, xp, yp, q, active):
    """f_{|x|,Q}(P) conjugated over ``tw``, branching on each bit."""
    shape = xp.shape[:-1]
    f = _one12(shape, xp.device)
    one2 = T2._const("one12", xp.device)[0, 0]
    t = torch.cat([q, one2.expand(tuple(shape) + (1, 2, NW))], -3)
    for bit in _X_BITS:
        f = tw.f12_mul_by_line(tw.f12_sqr(f), _tangent(tw, t, xp, yp))
        t = _double(tw, t)
        if bit:
            f = tw.f12_mul_by_line(f, _chord(tw, t, q, xp, yp))
            t = _madd(tw, t, q)
    f = tw.f12_conj(f)
    return torch.where(active.reshape(tuple(shape) + (1, 1, 1, 1)), f, _one12(shape, xp.device))


def _exp_by_x(tw, m, bits):
    r = m
    for bit in bits:
        r = tw.f12_cyclo_sqr(r)
        if bit:
            r = tw.f12_mul(r, m)
    return tw.f12_conj(r)


def _easy(tw, f):
    """(f[0] f[1])^((p^6 - 1)(p^2 + 1))."""
    x = tw.f12_mul(f[0], f[1])
    m = tw.f12_mul(tw.f12_conj(x), tw.f12_inv(x))
    return tw.f12_mul(tw.f12_frobenius_n(m, 2), m)


def _tail(tw, e5, w1, m):
    y = tw.f12_mul(tw.f12_mul(e5, tw.f12_frobenius_n(w1, 2)), tw.f12_conj(w1))
    return tw.f12_mul(y, tw.f12_mul(tw.f12_cyclo_sqr(m), m))


# ---------------------------------------------------------------------------
# Kernel P2: the Miller loop
# ---------------------------------------------------------------------------


def miller_loop_plain(xp, yp, q, active):
    """Plain version of P2 on any device: xp, yp [..., 12] Montgomery Fp,
    q [..., 2, 2, 12] (x2, y2 over Fp2), active bool [...] ->
    f [..., 2, 3, 2, 12]."""
    return _miller(T2.PLAIN, xp, yp, q, active)


def _check_words(name, x, shape, dtype=torch.int32):
    if x.dtype != dtype or tuple(x.shape[x.dim() - len(shape):]) != shape:
        raise ValueError(f"{name}: expected {dtype} [..., {', '.join(map(str, shape))}], got {x.dtype} {tuple(x.shape)}")


def miller_loop(xp, yp, q, active, group: int | None = None):
    """Batched f_{x,Q}(P) (conjugated, x < 0), one lane a (pair, check): on
    the card one launch of ``kzg_miller_loop``, all 63 steps, ``group``
    lanes a Miller lane (``tower.pairing_group`` by default); on the CPU
    the plain version.  Shapes as :func:`miller_loop_plain`."""
    for name, x, shape in (("xp", xp, (NW,)), ("yp", yp, (NW,)), ("q", q, (2, 2, NW))):
        _check_words(f"kzg_miller_loop {name}", x, shape)
    shape = tuple(xp.shape[:-1])
    if tuple(yp.shape[:-1]) != shape or tuple(q.shape[:-3]) != shape or tuple(active.shape) != shape or active.dtype != torch.bool:
        raise ValueError(f"kzg_miller_loop: lanes {shape}, yp {tuple(yp.shape)}, q {tuple(q.shape)}, active {active.dtype} {tuple(active.shape)}")
    if any(x.device != xp.device for x in (yp, q, active)):
        raise ValueError("kzg_miller_loop: operands on several devices")
    if xp.device.type == "cpu":
        return miller_loop_plain(xp, yp, q, active)
    n = math.prod(shape)
    out = torch.empty(shape + T2.FP12_SHAPE, dtype=torch.int32, device=xp.device)
    if n:
        if n >= 1 << 31:
            raise ValueError(f"kzg_miller_loop: {n} lanes exceed the kernel's 32-bit index")
        group = T2.pairing_group(n) if group is None else group
        T2._check_group("kzg_miller_loop", group)
        qx, qy = q[..., 0, :, :].contiguous(), q[..., 1, :, :].contiguous()
        _build.launch(
            "kzg_miller_loop", xp.device, xp.contiguous(), yp.contiguous(), qx, qy,
            active.contiguous().view(torch.uint8), out, n, group,
        )
    return out


# ---------------------------------------------------------------------------
# Kernel P3: the final exponentiation
# ---------------------------------------------------------------------------


def _hard_chain_packed(tw, m, bits):
    return _final_exp_hard_chain(
        m,
        lambda v: _exp_by_x(tw, v, bits),
        lambda a, b: tw.f12_mul(a, tw.f12_conj(b)),
        lambda a, b: tw.f12_mul(a, tw.f12_frobenius(b)),
    )


def final_exp_plain(f, bits=_ABS_X_BITS, value: bool = False):
    """Plain version of P3 on any device: the two Miller values f [2, ...,
    2, 3, 2, 12] multiplied, the easy part, the hard chain over ``bits`` (of
    |x| below the MSB, MSB first) and the tail -> the is-one flags [...],
    or with ``value`` the value before the test [..., 2, 3, 2, 12]."""
    tw = T2.PLAIN
    m = _easy(tw, f)
    e5, w1 = _hard_chain_packed(tw, m, bits)
    out = _tail(tw, e5, w1, m)
    return out if value else T2.fp12_is_one(out)


def final_exp(f, bits=_ABS_X_BITS, value: bool = False, group: int | None = None):
    """The final exponentiation and is-one test of each check: on the card
    one launch of ``kzg_final_exp``, ``group`` lanes a check
    (``tower.pairing_group`` by default); on the CPU the plain version.
    Shapes as :func:`final_exp_plain`; ``bits`` up to 64 zeros and ones."""
    _check_words("kzg_final_exp", f, T2.FP12_SHAPE)
    if f.dim() < 5 or f.shape[0] != 2:
        raise ValueError(f"kzg_final_exp: expected [2, ..., 2, 3, 2, 12] (the pair axis first), got {tuple(f.shape)}")
    bits = tuple(int(b) for b in bits)
    if len(bits) > 64 or any(b not in (0, 1) for b in bits):
        raise ValueError("kzg_final_exp: up to 64 bits, each 0 or 1")
    if f.device.type == "cpu":
        return final_exp_plain(f, bits, value)
    shape = tuple(f.shape[1:-4])
    k = math.prod(shape)
    out = torch.empty(shape + (T2.FP12_SHAPE if value else ()), dtype=torch.int32 if value else torch.uint8, device=f.device)
    if k:
        if k >= 1 << 31:
            raise ValueError(f"kzg_final_exp: {k} checks exceed the kernel's 32-bit index")
        group = T2.pairing_group(k) if group is None else group
        T2._check_group("kzg_final_exp", group)
        _build.launch("kzg_final_exp", f.device, f.contiguous(), out, k, bytes(bits), len(bits), int(value), group)
    return out if value else out.view(torch.bool)


# ---------------------------------------------------------------------------
# The JAX module's functions on nested tuples
# ---------------------------------------------------------------------------


def _q_packed(qx, qy):
    return _st([T2.pack(qx), T2.pack(qy)], -3)


def _g2_double(t):
    return T2.unpack(_double(T2.DEVICE, T2.pack(t)), 2)


def _g2_madd(t, q):
    """t projective + q affine (x2, y2), q never infinity."""
    return T2.unpack(_madd(T2.DEVICE, T2.pack(t), T2.pack(q)), 2)


def _fp6_mul_sparse01(a, y1, y2):
    """(x0 + x1 v + x2 v^2) * (y1 v + y2 v^2)."""
    y = T2.pack((T2.fp2_zeros(device=T2.pack(y1).device), y1, y2))
    return T2.unpack(T2.DEVICE.f6_mul(T2.pack(a), y), 2)


def fp12_mul_by_line(f, c00, c11, c12):
    """f * ((c00, 0, 0) + (0, c11, c12) w), the sparse shape of every line
    (golden/pairing.py:36-49): P1's ``mul_by_line`` on the card."""
    return T2.unpack(T2.DEVICE.f12_mul_by_line(T2.pack(f), T2.pack((c00, c11, c12))), 3)


def tangent_line_coeffs(t, xp, yp):
    """Sparse line coefficients of the tangent at projective t, scaled by
    2YZ^2: c00 = xi 2YZ^2 yP, c11 = 3X^3 - 2Y^2 Z, c12 = -3X^2 Z xP."""
    return T2.unpack(_tangent(T2.DEVICE, T2.pack(t), xp, yp), 2)


def chord_line_coeffs(t, q, xp, yp):
    """Sparse line coefficients of the chord through projective t and
    affine q, scaled by D = x2 Z - X."""
    return T2.unpack(_chord(T2.DEVICE, T2.pack(t), T2.pack(q), xp, yp), 2)


def miller_step(f, t, q, xp, yp):
    """One Miller iteration without the bit: ``(f_dbl, t_dbl, f_add,
    t_add)``, the state after the square, tangent line and doubling, and
    the same with the chord line and mixed add with q on top."""
    f_dbl, t_dbl, f_add, t_add = _step(T2.DEVICE, T2.pack(f), T2.pack(t), T2.pack(q), xp, yp)
    return T2.unpack(f_dbl, 3), T2.unpack(t_dbl, 2), T2.unpack(f_add, 3), T2.unpack(t_add, 2)


def miller_loop_kernel(xp, yp, qx, qy, active):
    """Batched f_{x,Q}(P) (conjugated, x < 0): xp, yp [2, ..., 12]
    Montgomery Fp; qx, qy Fp2 pairs of [2, ..., 12]; active bool [2, ...].
    Kernel P2 on the card."""
    return T2.unpack(miller_loop(xp, yp, _q_packed(qx, qy), active), 3)


def _exp_by_x_with_bits(m, abs_x_bits: tuple):
    """m^(-|x|) for cyclotomic m by square-and-multiply over the given
    MSB-first bits (below the implicit leading 1), conjugated at the end;
    production passes ``_ABS_X_BITS``."""
    return T2.unpack(_exp_by_x(T2.DEVICE, T2.pack(m), abs_x_bits), 3)


def _exp_by_x_kernel(m):
    return _exp_by_x_with_bits(m, _ABS_X_BITS)


def _easy_part_kernel(f):
    """The two Miller values (pair axis first) combined, and the easy part
    (f0 f1)^((p^6 - 1)(p^2 + 1))."""
    return T2.unpack(_easy(T2.DEVICE, T2.pack(f)), 3)


def _mul_conj_kernel(a, b):
    return T2.fp12_mul(a, T2.fp12_conj(b))


def _mul_frob_kernel(a, b):
    return T2.fp12_mul(a, T2.fp12_frobenius(b))


def _hard_tail_expr(e5, w1, m):
    """y = e5 frob^2(w1) conj(w1); the result y m^3: the final value of the
    cubed hard part."""
    return T2.unpack(_tail(T2.DEVICE, T2.pack(e5), T2.pack(w1), T2.pack(m)), 3)


def _hard_tail_kernel(e5, w1, m):
    return T2.fp12_is_one(_hard_tail_expr(e5, w1, m))


_hard_tail_value_kernel = _hard_tail_expr


def _final_exp_hard_chain(m, exp_by_x, mul_conj=_mul_conj_kernel, mul_frob=_mul_frob_kernel):
    """The five-exponentiation x-chain of the hard part, m^((x-1)^2), then
    ^(x+p), then ^(x^2), returning ``(e5, w1)`` for the tail.  The one place
    that holds the chain's order, conjugations and Frobenius: the plain P3
    and the tuple functions compose through it (P3's kernel follows it)."""
    u = mul_conj(exp_by_x(m), m)  # m^(x-1)
    u = mul_conj(exp_by_x(u), u)  # m^((x-1)^2)
    w1 = mul_frob(exp_by_x(u), u)  # ^(x+p)
    e5 = exp_by_x(exp_by_x(w1))
    return e5, w1


# ---------------------------------------------------------------------------
# The pairing check
# ---------------------------------------------------------------------------


def pairings_verify_kernel(xp, yp, qx, qy, active, bits=_ABS_X_BITS):
    """e(P0, Q0) e(P1, Q1) == 1 per check, P0 negated by the caller (the
    reference's shape, utils.rs:189-214): shapes as
    :func:`miller_loop_kernel`, a bool per check [...].  P2 then P3 on the
    card."""
    return final_exp(miller_loop(xp, yp, _q_packed(qx, qy), active), bits)


def _device(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pairings_verify_device: CUDA is not available; pass device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def pairing_inputs(checks, device):
    """Golden affine points -> the kernels' inputs: for each check (a1, a2,
    b1, b2) the pairs (-a1, a2) and (b1, b2), None meaning infinity (such a
    pair is inactive and yields one).  Returns (xp, yp, qx, qy, active) with
    the pair axis first, [2, K]."""
    from ..golden import curve as gc

    k = len(checks)
    vals = np.zeros((6, 2, k), dtype=object)
    active = np.zeros((2, k), dtype=bool)
    for j, (a1, a2, b1, b2) in enumerate(checks):
        for i, (p, q) in enumerate(((gc.g1_neg(a1), a2), (b1, b2))):
            if p is None or q is None:
                continue
            active[i, j] = True
            vals[:, i, j] = [p[0], p[1], q[0][0], q[0][1], q[1][0], q[1][1]]
    words = T2.const_words(vals, device)  # [6, 2, K, 12]
    xp, yp = words[0], words[1]
    qx, qy = (words[2], words[3]), (words[4], words[5])
    return xp, yp, qx, qy, torch.from_numpy(active).to(device)


def pairings_verify_device_batch(checks, device=None) -> list[bool]:
    """e(a1, a2) == e(b1, b2) for each (a1, a2, b1, b2) of ``checks``
    (golden affine points, None == infinity), all checks in one P2 and one
    P3 launch on the card (``device`` None: the current CUDA device, which
    must exist; ``"cpu"`` runs the plain versions)."""
    device = _device(device)
    if not checks:
        return []
    with _build.on_device(device):
        flags = pairings_verify_kernel(*pairing_inputs(checks, device))
        return [bool(v) for v in flags.cpu().tolist()]


def pairings_verify_device(a1, a2, b1, b2, device=None) -> bool:
    """Drop-in for ``golden.pairing.pairings_verify`` on the card:
    e(a1, a2) == e(b1, b2) as e(-a1, a2) e(b1, b2) == 1 (None ==
    infinity; both pairs at infinity give True, as blst does)."""
    return pairings_verify_device_batch([(a1, a2, b1, b2)], device)[0]
