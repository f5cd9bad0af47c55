"""The extension tower Fp2 -> Fp6 -> Fp12 on the port's word tensors.

Counterpart of the JAX package's ``ops/tower.py`` (the golden tower,
golden/field.py:137-393):

    Fp2  = (c0, c1)            u^2 = -1
    Fp6  = (a0, a1, a2)        v^3 = xi = 1 + u
    Fp12 = (b0, b1)            w^2 = v

The public functions take and return nested tuples of ``[..., 12]`` int32
Montgomery Fp tensors, as the JAX module's take ``[..., 32]`` limb arrays:
the two packages share the Fp radix 2^384, so each leaf is the same
integer in both (:mod:`.jax_state` carries the JAX package's tuples over).
Leading axes batch and broadcast.

Inside, an element is one packed tensor with its coefficients on trailing
axes, in the same nesting: Fp2 ``[..., 2, 12]``, Fp6 ``[..., 3, 2, 12]``,
Fp12 ``[..., 2, 3, 2, 12]`` (:func:`pack`, :func:`unpack`).  A
:class:`Tower` computes on packed elements over one set of Fp operations
and stacks the independent products of a step into one Fp product call
(the 3 of an Fp2 product, the 6 Fp2 products of an Fp6 product, the 3 Fp6
products of an Fp12 product), and the linear combinations likewise:

* ``PLAIN`` composes the plain versions on any device: the plain version of
  kernel P1 (``kzg_fp12_op``, ``csrc/pairing_kernels.cu`` over
  ``csrc/tower.cuh``), and of P2 and P3 in :mod:`.pairing`.
* ``DEVICE``, which the public functions run on, composes :mod:`.limbs`'
  dispatching operations (on the card ``kzg_fp_mont_mul`` (K1),
  ``kzg_fp_add``, ``kzg_fp_sub`` and the Fp chain ``kzg_fp_pow_const``, on
  the CPU their plain versions), and its six Fp12 functions
  (:data:`FP12_OPS`) go through :func:`fp12_op`: one launch of P1 on a
  CUDA tensor (each function's program of :mod:`.pairing_programs` over a
  group of lanes an element), the plain version on a CPU one.

Every value is canonical, so each function gives the same words whatever
the order of its field operations: only the formulas that are not plain
field arithmetic must be the JAX module's (the Granger-Scott squaring,
here and in the kernel, is its formula).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..golden import field as gf
from . import _build
from . import limbs as L
from .limbs import FP

NW = FP.nwords

# ---------------------------------------------------------------------------
# Packing (nested tuples <-> packed tensors)
# ---------------------------------------------------------------------------


def _stack(parts, dim):
    return torch.stack(torch.broadcast_tensors(*parts), dim)


def pack(x) -> torch.Tensor:
    """A nested tuple of ``[..., 12]`` tensors -> one packed tensor, each
    tuple level a trailing axis before the words (leading axes broadcast)."""
    if isinstance(x, torch.Tensor):
        return x
    return _stack([pack(p) for p in x], -_levels(x))


def _levels(x) -> int:
    """Trailing axes of x packed: 1 for an Fp tensor, +1 for each tuple level."""
    return 1 if isinstance(x, torch.Tensor) else 1 + _levels(x[0])


def unpack(x: torch.Tensor, levels: int):
    """A packed tensor -> nested tuples of views, ``levels`` tuple levels
    (1 for Fp2, 2 for Fp6, 3 for Fp12)."""
    if levels == 0:
        return x
    dim = -(levels + 1)
    return tuple(unpack(x.select(dim, i), levels - 1) for i in range(x.shape[dim]))


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------


def _mont(v: int) -> int:
    return v * FP.mont_r % FP.modulus


def const_words(values, device) -> torch.Tensor:
    """Python ints (nested lists) -> Montgomery words, the nesting as axes."""
    arr = np.asarray(values, dtype=object)
    flat = [_mont(int(v)) for v in arr.reshape(-1)]
    return torch.from_numpy(L.ints_to_words(NW, flat).reshape(arr.shape + (NW,))).to(device)


_CONSTS: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(torch.device(device)))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = const_words(_CONST_VALUES[name], device)
    return t


# Frobenius coefficients gamma^k = xi^(k (p - 1) / 6) (golden/field.py:412),
# packed as the Fp12 coefficient of w^k they multiply: [h][j] is w^(2j + h).
_GAMMA_POWERS_INT = gf._GAMMA_POWERS
_CONST_VALUES = {
    "one12": [[[1, 0], [0, 0], [0, 0]], [[0, 0], [0, 0], [0, 0]]],
    "gamma": [[list(_GAMMA_POWERS_INT[2 * j + h]) for j in range(3)] for h in range(2)],
    "b3": [12, 12],  # the twist's 3 b' = 3 * 4 (1 + u)
}


# ---------------------------------------------------------------------------
# The tower on packed elements
# ---------------------------------------------------------------------------


class Tower:
    """Fp2, Fp6 and Fp12 arithmetic on packed elements over one set of Fp
    operations: ``mul`` (Montgomery product), ``add``, ``sub`` (modular,
    broadcasting) and ``inv`` (Fermat; inv(0) = 0)."""

    def __init__(self, mul, add, sub, inv):
        self.mul, self.add, self.sub, self.inv = mul, add, sub, inv

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    # -- Fp2 [..., 2, 12] ----------------------------------------------------

    def f2_mul(self, a, b):
        """Karatsuba: the three products in one call."""
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        s = self.add(_stack([a0, b0], 0), _stack([a1, b1], 0))
        t = self.mul(_stack([a0, a1, s[0]], -2), _stack([b0, b1, s[1]], -2))
        t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        d = self.sub(_stack([t0, t2], -2), _stack([t1, t0], -2))
        return _stack([d[..., 0, :], self.sub(d[..., 1, :], t1)], -2)

    def f2_sqr(self, a):
        """(a0 + a1)(a0 - a1) + 2 a0 a1 u: the two products in one call."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        s = self.add(_stack([a0, a0], -2), _stack([a1, a0], -2))
        d = self.sub(a0, a1)
        return self.mul(s, _stack([d, a1], -2))

    def f2_mul_fp(self, a, k):
        return self.mul(a, k.unsqueeze(-2))

    def f2_mul_xi(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        return _stack([self.sub(a0, a1), self.add(a0, a1)], -2)

    def f2_conj(self, a):
        return _stack([a[..., 0, :], self.neg(a[..., 1, :])], -2)

    def f2_inv(self, a):
        """(a0 - a1 u) / (a0^2 + a1^2); inv(0) = 0."""
        sq = self.mul(a, a)
        ninv = self.inv(self.add(sq[..., 0, :], sq[..., 1, :]))
        r = self.mul(a, ninv.unsqueeze(-2))
        return _stack([r[..., 0, :], self.neg(r[..., 1, :])], -2)

    # -- Fp6 [..., 3, 2, 12] -------------------------------------------------

    def f6_mul(self, a, b):
        """Karatsuba-Toom over v^3 = xi (golden/field.py:275-287): the six
        Fp2 products in one Fp2 product."""
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, a2 = (a[..., k, :, :] for k in range(3))
        b0, b1, b2 = (b[..., k, :, :] for k in range(3))
        s = self.add(_stack([a1, a0, a0, b1, b0, b0], -3), _stack([a2, a1, a2, b2, b1, b2], -3))
        t = self.f2_mul(
            torch.cat([a, s[..., :3, :, :]], -3), torch.cat([b, s[..., 3:, :, :]], -3)
        )  # t0, t1, t2, (a1+a2)(b1+b2), (a0+a1)(b0+b1), (a0+a2)(b0+b2)
        t0, t1, t2 = (t[..., k, :, :] for k in range(3))
        d = self.sub(t[..., 3:, :, :], _stack([t1, t0, t0], -3))
        d = self.sub(d, _stack([t2, t1, t2], -3))
        x = self.f2_mul_xi(_stack([d[..., 0, :, :], t2], -3))
        return self.add(_stack([t0, d[..., 1, :, :], d[..., 2, :, :]], -3), _stack([x[..., 0, :, :], x[..., 1, :, :], t1], -3))

    def f6_mul_by_v(self, a):
        return _stack([self.f2_mul_xi(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], -3)

    def f6_mul_fp2(self, a, k):
        return self.f2_mul(a, k.unsqueeze(-3))

    def f6_inv(self, a):
        """golden/field.py:303-313: six products, then three, one Fp2
        inversion and three more."""
        a0, a1, a2 = (a[..., k, :, :] for k in range(3))
        p = self.f2_mul(_stack([a0, a1, a2, a0, a1, a0], -3), _stack([a0, a2, a2, a1, a1, a2], -3))
        x = self.f2_mul_xi(p[..., 1:3, :, :])  # xi a1 a2, xi a2^2
        t = self.sub(
            _stack([p[..., 0, :, :], x[..., 1, :, :], p[..., 4, :, :]], -3),
            _stack([x[..., 0, :, :], p[..., 3, :, :], p[..., 5, :, :]], -3),
        )  # t0, t1, t2
        q = self.f2_mul(_stack([a0, a2, a1], -3), t)  # a0 t0, a2 t1, a1 t2
        factor = self.add(q[..., 0, :, :], self.f2_mul_xi(self.add(q[..., 1, :, :], q[..., 2, :, :])))
        return self.f2_mul(t, self.f2_inv(factor).unsqueeze(-3))

    # -- Fp12 [..., 2, 3, 2, 12] ---------------------------------------------

    def f12_mul(self, a, b):
        """The three Fp6 products in one."""
        a, b = torch.broadcast_tensors(a, b)
        s = self.add(_stack([a[..., 0, :, :, :], b[..., 0, :, :, :]], 0), _stack([a[..., 1, :, :, :], b[..., 1, :, :, :]], 0))
        t = self.f6_mul(torch.cat([a, s[0].unsqueeze(-4)], -4), torch.cat([b, s[1].unsqueeze(-4)], -4))
        t0, t1, m = (t[..., k, :, :, :] for k in range(3))
        c1 = self.sub(self.sub(m, t0), t1)
        return _stack([self.add(t0, self.f6_mul_by_v(t1)), c1], -4)

    def f12_sqr(self, a):
        """Complex squaring: t = a0 a1 and (a0 + a1)(a0 + v a1) in one Fp6
        product; c0 = that - t - v t, c1 = 2 t."""
        a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
        s = self.add(_stack([a0, a0], -4), _stack([a1, self.f6_mul_by_v(a1)], -4))
        t = self.f6_mul(_stack([a0, s[..., 0, :, :, :]], -4), _stack([a1, s[..., 1, :, :, :]], -4))
        tt, m = t[..., 0, :, :, :], t[..., 1, :, :, :]
        c0 = self.sub(self.sub(m, tt), self.f6_mul_by_v(tt))
        return _stack([c0, self.add(tt, tt)], -4)

    def f12_conj(self, a):
        return _stack([a[..., 0, :, :, :], self.neg(a[..., 1, :, :, :])], -4)

    def f12_inv(self, a):
        sq = self.f6_mul(a, a)
        norm = self.sub(sq[..., 0, :, :, :], self.f6_mul_by_v(sq[..., 1, :, :, :]))
        r = self.f6_mul(a, self.f6_inv(norm).unsqueeze(-4))
        return _stack([r[..., 0, :, :, :], self.neg(r[..., 1, :, :, :])], -4)

    def f12_cyclo_sqr(self, a):
        """Granger-Scott squaring (golden/field.py fp12_cyclo_sqr): its nine
        Fp2 squarings in one call."""
        g = [a[..., k // 3, k % 3, :, :] for k in range(6)]  # g0 .. g5
        s = self.add(_stack([g[4], g[2], g[5]], -3), _stack([g[0], g[3], g[1]], -3))
        sq = self.f2_sqr(torch.cat([_stack([g[4], g[0], g[2], g[3], g[5], g[1]], -3), s], -3))
        t = [sq[..., k, :, :] for k in range(9)]  # t0 .. t5, then the sums' squares
        d = self.sub(self.sub(sq[..., 6:, :, :], _stack([t[0], t[2], t[4]], -3)), _stack([t[1], t[3], t[5]], -3))
        t6, t7 = d[..., 0, :, :], d[..., 1, :, :]
        x = self.f2_mul_xi(_stack([d[..., 2, :, :], t[0], t[2], t[4]], -3))
        t8 = x[..., 0, :, :]
        tt = self.add(x[..., 1:, :, :], _stack([t[1], t[3], t[5]], -3))  # t0, t2, t4 after
        big = torch.cat([tt, _stack([t8, t6, t7], -3)], -3)
        u = torch.cat(
            [self.sub(tt, _stack(g[:3], -3)), self.add(big[..., 3:, :, :], _stack(g[3:], -3))], -3
        )
        z = self.add(self.add(u, u), big)
        return z.unflatten(-3, (2, 3))

    def f12_frobenius(self, a):
        conj = torch.cat([a[..., :1, :], self.neg(a[..., 1:, :])], -2)
        return self.f2_mul(conj, _const("gamma", a.device))

    def f12_mul_by_line(self, f, line):
        """f times the sparse line ((c00, 0, 0), (0, c11, c12)), ``line``
        [..., 3, 2, 12] = (c00, c11, c12): a full Fp12 product by the line's
        element, the same value as the kernel's sparse one."""
        zero = torch.zeros_like(line[..., 0, :, :])
        c00, c11, c12 = (line[..., k, :, :] for k in range(3))
        elt = _stack([_stack([c00, zero, zero], -3), _stack([zero, c11, c12], -3)], -4)
        return self.f12_mul(f, elt)

    def f12_frobenius_n(self, a, n: int):
        for _ in range(n):
            a = self.f12_frobenius(a)
        return a


def _plain_inv(a):
    return L.mont_pow_const_plain(FP, a, FP.modulus - 2)


PLAIN = Tower(
    lambda a, b: L.mont_mul_plain(FP, a, b),
    lambda a, b: L.add_mod_plain(FP, a, b),
    lambda a, b: L.sub_mod_plain(FP, a, b),
    _plain_inv,
)


# ---------------------------------------------------------------------------
# Kernel P1: one Fp12 function over [n] elements
# ---------------------------------------------------------------------------

# Op codes of kzg_fp12_op (csrc/pairing_kernels.cu Fp12Op).
FP12_OPS = {"mul": 0, "sqr": 1, "cyclo_sqr": 2, "frobenius": 3, "inv": 4, "mul_by_line": 5}
FP12_SHAPE = (2, 3, 2, NW)
LINE_SHAPE = (3, 2, NW)

# The kernels P1-P3 give each element, Miller lane or check a group of G
# lanes of a warp (csrc/pairing_kernels.cu).  The default by width is the
# card's (chip_smoke.py phase 3h sweeps G; PERF.md).
GROUP_LANES = (8, 16, 32)
GROUP_NARROW_BELOW = 2048  # groups a launch from which G is 16, below it 32


def pairing_group(groups: int) -> int:
    """G for a launch of ``groups`` groups (elements, Miller lanes or
    checks): 32 lanes a group below 2,048 groups, where the card has room
    for every group's warp and a level's products spread widest; 16 from
    there, where two groups share a warp and fewer lanes idle (chip_smoke.py
    phase 3h's sweep on an H100 80GB HBM3 at 700 W: P2 at [2, 1024] 1.99
    ms with 16, 2.20 with 32; P3 at 1,024 checks 2.26 ms with 32, 2.43
    with 16)."""
    return 32 if groups < GROUP_NARROW_BELOW else 16


def _check_group(name: str, group) -> None:
    if group not in GROUP_LANES:
        raise ValueError(f"{name}: group must be one of {GROUP_LANES}, got {group}")


def fp12_op_plain(op: str, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of P1 on any device: ``PLAIN``'s function ``op``."""
    fn = getattr(PLAIN, "f12_" + op)
    return fn(a) if b is None else fn(a, b)


def fp12_op(op: str, a: torch.Tensor, b: torch.Tensor | None = None, group: int | None = None) -> torch.Tensor:
    """Fp12 function ``op`` (:data:`FP12_OPS`) on packed elements ``a``
    [..., 2, 3, 2, 12] and, for ``mul`` and ``mul_by_line``, ``b`` (an Fp12,
    or the line's [..., 3, 2, 12]), leading axes broadcast.  On the card one
    launch of ``kzg_fp12_op`` over the elements, ``group`` lanes an element
    (:func:`pairing_group` by default); on the CPU the plain version."""
    if op not in FP12_OPS:
        raise ValueError(f"kzg_fp12_op: unknown op {op!r}")
    binary = op in ("mul", "mul_by_line")
    if binary != (b is not None):
        raise ValueError(f"kzg_fp12_op: {op} takes {'two operands' if binary else 'one operand'}")
    want = {"mul": FP12_SHAPE, "mul_by_line": LINE_SHAPE}.get(op)
    for x, shape in ((a, FP12_SHAPE), (b, want)):
        if x is not None and (x.dtype != torch.int32 or tuple(x.shape[-len(shape):]) != shape or x.device != a.device):
            raise ValueError(f"kzg_fp12_op: expected int32 [..., {', '.join(map(str, shape))}] on {a.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if a.device.type == "cpu":
        return fp12_op_plain(op, a, b)
    lead = a.shape[:-4] if b is None else torch.broadcast_shapes(a.shape[:-4], b.shape[: -len(want)])
    n = math.prod(lead)
    a = a.expand(tuple(lead) + FP12_SHAPE).contiguous()
    if b is not None:
        b = b.expand(tuple(lead) + want).contiguous()
    out = torch.empty(tuple(lead) + FP12_SHAPE, dtype=torch.int32, device=a.device)
    if n:
        if n >= 1 << 31:
            raise ValueError(f"kzg_fp12_op: {n} elements exceed the kernel's 32-bit index")
        group = pairing_group(n) if group is None else group
        _check_group("kzg_fp12_op", group)
        _build.launch("kzg_fp12_op", a.device, a, b, out, n, FP12_OPS[op], group)
    return out


class _Device(Tower):
    """The dispatching tower, its six Fp12 functions through :func:`fp12_op`."""

    def f12_mul(self, a, b):
        return fp12_op("mul", a, b)

    def f12_sqr(self, a):
        return fp12_op("sqr", a)

    def f12_cyclo_sqr(self, a):
        return fp12_op("cyclo_sqr", a)

    def f12_frobenius(self, a):
        return fp12_op("frobenius", a)

    def f12_inv(self, a):
        return fp12_op("inv", a)

    def f12_mul_by_line(self, f, line):
        return fp12_op("mul_by_line", f, line)


DEVICE = _Device(
    lambda a, b: L.mont_mul(FP, a, b),
    lambda a, b: L.add_mod(FP, a, b),
    lambda a, b: L.sub_mod(FP, a, b),
    lambda a: L.mont_inv(FP, a),
)


# ---------------------------------------------------------------------------
# The JAX module's functions on nested tuples
# ---------------------------------------------------------------------------


def _on(fn, levels: int, *args):
    return unpack(fn(*(pack(a) for a in args)), levels)


def _zeros(shape, device):
    return torch.zeros(tuple(shape) + (NW,), dtype=torch.int32, device=device)


def _one_mont(shape, device):
    return FP.const("one_mont", device).expand(tuple(shape) + (NW,)).contiguous()


# Fp2


def fp2_zeros(shape=(), device="cpu"):
    z = _zeros(shape, device)
    return (z, z)


def fp2_one(shape=(), device="cpu"):
    return (_one_mont(shape, device), _zeros(shape, device))


def fp2_add(a, b):
    return (L.add_mod(FP, a[0], b[0]), L.add_mod(FP, a[1], b[1]))


def fp2_sub(a, b):
    return (L.sub_mod(FP, a[0], b[0]), L.sub_mod(FP, a[1], b[1]))


def fp2_neg(a):
    return (L.neg_mod(FP, a[0]), L.neg_mod(FP, a[1]))


def fp2_conj(a):
    return (a[0], L.neg_mod(FP, a[1]))


def fp2_mul(a, b):
    return _on(DEVICE.f2_mul, 1, a, b)


def fp2_sqr(a):
    return _on(DEVICE.f2_sqr, 1, a)


def fp2_mul_fp(a, k):
    return unpack(DEVICE.f2_mul_fp(pack(a), k), 1)


def fp2_mul_by_xi(a):
    """Multiply by xi = 1 + u: (c0 - c1, c0 + c1)."""
    return (L.sub_mod(FP, a[0], a[1]), L.add_mod(FP, a[0], a[1]))


def fp2_double(a):
    return fp2_add(a, a)


def fp2_inv(a):
    """(a0 - a1 u) / (a0^2 + a1^2), Fermat inversion of the norm; inv(0) = 0."""
    return _on(DEVICE.f2_inv, 1, a)


def fp2_is_zero(a):
    return L.is_zero(a[0]) & L.is_zero(a[1])


def fp2_select(mask, a, b):
    m = mask.unsqueeze(-1)
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]))


def fp2_const(c0: int, c1: int, shape=(), device="cpu"):
    """Python ints -> a Montgomery Fp2 constant, broadcast to ``shape``."""
    w = const_words([c0, c1], device)
    return tuple(w[k].expand(tuple(shape) + (NW,)) for k in range(2))


# Fp6


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    return _on(DEVICE.f6_mul, 2, a, b)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_mul_fp2(a, k):
    return _on(DEVICE.f6_mul_fp2, 2, a, k)


def fp6_inv(a):
    return _on(DEVICE.f6_inv, 2, a)


def fp6_zeros(shape=(), device="cpu"):
    return (fp2_zeros(shape, device), fp2_zeros(shape, device), fp2_zeros(shape, device))


def fp6_one(shape=(), device="cpu"):
    return (fp2_one(shape, device), fp2_zeros(shape, device), fp2_zeros(shape, device))


# Fp12


def fp12_one(shape=(), device="cpu"):
    return (fp6_one(shape, device), fp6_zeros(shape, device))


def fp12_mul(a, b):
    return _on(DEVICE.f12_mul, 3, a, b)


def fp12_sqr(a):
    """Complex squaring (2 Fp6 products)."""
    return _on(DEVICE.f12_sqr, 3, a)


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    return _on(DEVICE.f12_inv, 3, a)


def fp12_cyclo_sqr(a):
    """Granger-Scott squaring in the cyclotomic subgroup (its formula on any
    input, as the JAX function)."""
    return _on(DEVICE.f12_cyclo_sqr, 3, a)


def fp12_frobenius(a):
    return _on(DEVICE.f12_frobenius, 3, a)


def fp12_frobenius_n(a, n: int):
    for _ in range(n):
        a = fp12_frobenius(a)
    return a


def fp12_is_one(a):
    """bool tensor: a == 1 (canonical Montgomery comparison)."""
    x = pack(a)
    return (x == _const("one12", x.device)).flatten(-4).all(-1)


# ---------------------------------------------------------------------------
# Host codecs (golden tower values <-> tensors), for tests
# ---------------------------------------------------------------------------


def fp2_from_golden(a, shape=(), device="cpu"):
    return fp2_const(a[0], a[1], shape, device)


def fp12_from_golden(x, shape=(), device="cpu"):
    return tuple(tuple(fp2_from_golden(c, shape, device) for c in h) for h in x)


def fp12_to_golden(x):
    """An unbatched Fp12 (nested tuple or packed [2, 3, 2, 12]) -> golden
    nested-int tuples."""
    vals = L.words_to_ints(L.from_mont(FP, pack(x).reshape(-1, NW)))
    it = iter(vals)
    return tuple(tuple((next(it), next(it)) for _ in range(3)) for _ in range(2))
