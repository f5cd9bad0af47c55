"""The device pairing's programs: the tower's functions, the Miller steps
and the parts of the final exponentiation as levels of independent Fp
operations over a lane group's frame in shared memory.

Kernels P1-P3 (``csrc/pairing_kernels.cu``) give each element, Miller
lane or check a group of G lanes and a frame of Fp slots (48 bytes each)
in shared memory: named registers that hold the kernel's values between
programs (Fp12 values, the G2 point T, the points P and Q), the
constants, and scratch.  A program is a list of levels, each a set of Fp
operations whose operands are already in the frame:

* a product level: Montgomery products ``dst = a * b``;
* a linear level: ``dst = a +- b +- c`` (a negation is ``0 - a``, with 0
  a constant slot);
* an inversion level: one Fermat inversion ``dst = a^(p-2)`` (inv(0) =
  0), which the whole group runs as one chain.

Lane j of a group takes operations j, j + G, ... of a level, and the group
syncs between levels (``csrc/tower.cuh`` ``run_program``).  A program is
built by tracing the tower's formulas (:class:`_Tower`, the formulas of
golden/field.py and of the JAX package's ops/tower.py and ops/pairing.py)
over symbolic Fp values; the trace merges equal subexpressions and drops
operations on the constants 0 and 1.  Each chain of additions and
subtractions between products is expanded into one signed sum and summed
again three terms an operation, the earliest-ready terms first; a product
goes to the level after its last product operand, and a linear operation
to the linear levels before the first product that needs it (so a chain
that no product needs soon waits and does not hold the next products
back); scratch slots are reused once a value is dead.
Every value is canonical, so a program computes the same words as any
other arrangement of the same polynomial: the G2 formulas (RCB, b3 = 12 +
12u), the line scales 2YZ^2 and x2 Z - X and the Granger-Scott squaring
are the JAX package's polynomials; products by small integers and by xi
are additions.

:func:`header_text` is ``pairing_programs.cuh``, the tables the kernels
read, which ``ops/_build.py`` writes into the build directory before it
compiles; ``python -m kzg_rust_tpu_torch.ops.pairing_programs`` prints
every program's level counts.  tests/test_torch_pairing.py decodes those
tables back into the programs and runs every program with Python ints
(:func:`execute`) against golden/field.py.
"""

from __future__ import annotations

from ..golden import field as gf

P = gf.P
SLOT_BITS = 10
MAX_SLOTS = 1 << SLOT_BITS
INLINE_TERMS = 6
SUM_TERMS = 3  # terms of a linear op: a +- b +- c
OP_MUL, OP_LIN, OP_INV = 0, 1, 2
LEVEL_MUL, LEVEL_LIN, LEVEL_INV = 0, 1, 2
# Bits of |x| below its MSB, MSB first (the Miller loop's).
X_BITS = tuple((gf.BLS_X >> i) & 1 for i in range(gf.BLS_X.bit_length() - 2, -1, -1))


# ---------------------------------------------------------------------------
# Symbolic Fp values
# ---------------------------------------------------------------------------


class Val:
    """One Fp value of a trace: an input slot, a constant, or an operation."""

    __slots__ = ("op", "args", "id", "value")

    def __init__(self, op: str, args: tuple, ident: int, value=None):
        self.op, self.args, self.id, self.value = op, args, ident, value


class _Trace:
    """The field of a trace: each operation makes (or finds) a Val."""

    def __init__(self):
        self.vals: list[Val] = []
        self._memo: dict = {}
        self.zero = self.const(0)
        self.one = self.const(1)

    def _make(self, op: str, args: tuple, key=None, value=None) -> Val:
        key = key or (op,) + tuple(a.id for a in args)
        v = self._memo.get(key)
        if v is None:
            v = self._memo[key] = Val(op, args, len(self.vals), value)
            self.vals.append(v)
        return v

    def input(self, slot: int) -> Val:
        return self._make("in", (), ("in", slot), slot)

    def const(self, value: int) -> Val:
        value %= P
        return self._make("const", (), ("const", value), value)

    def mul(self, a: Val, b: Val) -> Val:
        if a.op == "const" and b.op == "const":
            return self.const(a.value * b.value)
        if a is self.zero or b is self.zero:
            return self.zero
        if a is self.one:
            return b
        if b is self.one:
            return a
        a, b = sorted((a, b), key=lambda v: v.id)
        return self._make("mul", (a, b))

    def add(self, a: Val, b: Val) -> Val:
        if a.op == "const" and b.op == "const":
            return self.const(a.value + b.value)
        if a is self.zero:
            return b
        if b is self.zero:
            return a
        a, b = sorted((a, b), key=lambda v: v.id)
        return self._make("add", (a, b))

    def sub(self, a: Val, b: Val) -> Val:
        if a.op == "const" and b.op == "const":
            return self.const(a.value - b.value)
        if b is self.zero:
            return a
        if a is b:
            return self.zero
        return self._make("sub", (a, b))

    def neg(self, a: Val) -> Val:
        if a.op == "sub" and a.args[0] is not self.zero:
            return self.sub(a.args[1], a.args[0])
        return self.sub(self.zero, a)

    def inv(self, a: Val) -> Val:
        return self._make("inv", (a,))


# ---------------------------------------------------------------------------
# The tower's formulas over a field F (a _Trace)
# ---------------------------------------------------------------------------


class _Tower:
    """Fp2 = (c0, c1), Fp6 = (a0, a1, a2), Fp12 = (b0, b1) over F; the
    formulas of golden/field.py and the JAX package's ops/tower.py."""

    def __init__(self, F):
        self.F = F

    # -- Fp2 --
    def f2_add(self, a, b):
        return (self.F.add(a[0], b[0]), self.F.add(a[1], b[1]))

    def f2_sub(self, a, b):
        return (self.F.sub(a[0], b[0]), self.F.sub(a[1], b[1]))

    def f2_neg(self, a):
        return (self.F.neg(a[0]), self.F.neg(a[1]))

    def f2_conj(self, a):
        return (a[0], self.F.neg(a[1]))

    def f2_small(self, a, k: int):
        """k a for a small k > 0 by additions (double and add)."""
        return tuple(self._small(c, k) for c in a)

    def _small(self, x, k: int):
        if k == 1:
            return x
        half = self._small(x, k // 2)
        r = self.F.add(half, half)
        return self.F.add(r, x) if k & 1 else r

    def f2_mul_xi(self, a):
        """xi a = (1 + u) a = (a0 - a1, a0 + a1)."""
        return (self.F.sub(a[0], a[1]), self.F.add(a[0], a[1]))

    def f2_mul(self, a, b):
        """Karatsuba over u^2 = -1: 3 products."""
        F = self.F
        t0, t1 = F.mul(a[0], b[0]), F.mul(a[1], b[1])
        m = F.mul(F.add(a[0], a[1]), F.add(b[0], b[1]))
        return (F.sub(t0, t1), F.sub(m, F.add(t0, t1)))

    def f2_sqr(self, a):
        """(a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 products."""
        F = self.F
        return (F.mul(F.add(a[0], a[1]), F.sub(a[0], a[1])), F.mul(F.add(a[0], a[0]), a[1]))

    def f2_mul_fp(self, a, k):
        return (self.F.mul(a[0], k), self.F.mul(a[1], k))

    def f2_mul_const(self, a, c: tuple):
        """a times the constant (c0, c1) (plain ints): 2 products where c0
        or c1 is 0 or c0 == c1, else Karatsuba with c0 + c1 folded."""
        F = self.F
        c0, c1 = c[0] % P, c[1] % P
        if c1 == 0:
            return self.f2_mul_fp(a, F.const(c0))
        if c0 == 0:
            k = F.const(c1)
            return (F.neg(F.mul(a[1], k)), F.mul(a[0], k))
        if c0 == c1:
            k = F.const(c0)
            return (F.mul(F.sub(a[0], a[1]), k), F.mul(F.add(a[0], a[1]), k))
        t0, t1 = F.mul(a[0], F.const(c0)), F.mul(a[1], F.const(c1))
        m = F.mul(F.add(a[0], a[1]), F.const(c0 + c1))
        return (F.sub(t0, t1), F.sub(m, F.add(t0, t1)))

    def f2_inv(self, a):
        F = self.F
        ninv = F.inv(F.add(F.mul(a[0], a[0]), F.mul(a[1], a[1])))
        return (F.mul(a[0], ninv), F.neg(F.mul(a[1], ninv)))

    # -- Fp6 --
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_neg(self, a):
        return tuple(self.f2_neg(x) for x in a)

    def f6_mul_by_v(self, a):
        return (self.f2_mul_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):
        """Karatsuba-Toom over v^3 = xi: 6 Fp2 products (golden/field.py
        fp6_mul)."""
        t0, t1, t2 = self.f2_mul(a[0], b[0]), self.f2_mul(a[1], b[1]), self.f2_mul(a[2], b[2])
        m12 = self.f2_mul(self.f2_add(a[1], a[2]), self.f2_add(b[1], b[2]))
        m01 = self.f2_mul(self.f2_add(a[0], a[1]), self.f2_add(b[0], b[1]))
        m02 = self.f2_mul(self.f2_add(a[0], a[2]), self.f2_add(b[0], b[2]))
        c0 = self.f2_add(t0, self.f2_mul_xi(self.f2_sub(m12, self.f2_add(t1, t2))))
        c1 = self.f2_add(self.f2_sub(m01, self.f2_add(t0, t1)), self.f2_mul_xi(t2))
        c2 = self.f2_add(self.f2_sub(m02, self.f2_add(t0, t2)), t1)
        return (c0, c1, c2)

    def f6_mul_fp2(self, a, k):
        return tuple(self.f2_mul(x, k) for x in a)

    def f6_mul_sparse01(self, a, y1, y2):
        """a (y1 v + y2 v^2): 5 Fp2 products."""
        m11, m22 = self.f2_mul(a[1], y1), self.f2_mul(a[2], y2)
        s = self.f2_mul(self.f2_add(a[1], a[2]), self.f2_add(y1, y2))
        c0 = self.f2_mul_xi(self.f2_sub(s, self.f2_add(m11, m22)))
        c1 = self.f2_add(self.f2_mul(a[0], y1), self.f2_mul_xi(m22))
        c2 = self.f2_add(self.f2_mul(a[0], y2), m11)
        return (c0, c1, c2)

    def f6_inv(self, a):
        """golden/field.py fp6_inv."""
        a0, a1, a2 = a
        t0 = self.f2_sub(self.f2_sqr(a0), self.f2_mul_xi(self.f2_mul(a1, a2)))
        t1 = self.f2_sub(self.f2_mul_xi(self.f2_sqr(a2)), self.f2_mul(a0, a1))
        t2 = self.f2_sub(self.f2_sqr(a1), self.f2_mul(a0, a2))
        factor = self.f2_add(self.f2_mul(a0, t0), self.f2_mul_xi(self.f2_add(self.f2_mul(a2, t1), self.f2_mul(a1, t2))))
        finv = self.f2_inv(factor)
        return (self.f2_mul(t0, finv), self.f2_mul(t1, finv), self.f2_mul(t2, finv))

    # -- Fp12 --
    def f12_conj(self, a):
        return (a[0], self.f6_neg(a[1]))

    def f12_mul(self, a, b):
        """3 Fp6 products."""
        t0, t1 = self.f6_mul(a[0], b[0]), self.f6_mul(a[1], b[1])
        s = self.f6_mul(self.f6_add(a[0], a[1]), self.f6_add(b[0], b[1]))
        return (self.f6_add(t0, self.f6_mul_by_v(t1)), self.f6_sub(s, self.f6_add(t0, t1)))

    def f12_sqr(self, a):
        """Complex squaring, 2 Fp6 products: c0 = (a0 + a1)(a0 + v a1) -
        t - v t, c1 = 2 t with t = a0 a1."""
        t = self.f6_mul(a[0], a[1])
        s = self.f6_mul(self.f6_add(a[0], a[1]), self.f6_add(a[0], self.f6_mul_by_v(a[1])))
        return (self.f6_sub(s, self.f6_add(t, self.f6_mul_by_v(t))), self.f6_add(t, t))

    def f12_cyclo_sqr(self, a):
        """Granger-Scott squaring, 9 Fp2 squarings (golden/field.py
        fp12_cyclo_sqr, the JAX formula on any input)."""
        (g0, g1, g2), (g3, g4, g5) = a
        sq, add, sub, xi = self.f2_sqr, self.f2_add, self.f2_sub, self.f2_mul_xi
        t0, t1 = sq(g4), sq(g0)
        t6 = sub(sq(add(g4, g0)), add(t0, t1))  # 2 g0 g4
        t2, t3 = sq(g2), sq(g3)
        t7 = sub(sq(add(g2, g3)), add(t2, t3))  # 2 g2 g3
        t4, t5 = sq(g5), sq(g1)
        t8 = xi(sub(sq(add(g5, g1)), add(t4, t5)))  # 2 g1 g5 xi
        t0 = add(xi(t0), t1)
        t2 = add(xi(t2), t3)
        t4 = add(xi(t4), t5)

        def term(t, g, plus):
            return add(self.f2_small(add(t, g) if plus else sub(t, g), 2), t)

        return ((term(t0, g0, False), term(t2, g1, False), term(t4, g2, False)), (term(t8, g3, True), term(t6, g4, True), term(t7, g5, True)))

    def f12_frobenius(self, a):
        """Coefficient k of w^k (a[k % 2][k // 2]) conjugated times gamma^k."""
        out = [[None] * 3, [None] * 3]
        for h in range(2):
            for j in range(3):
                e = 2 * j + h
                x = self.f2_conj(a[h][j])
                out[h][j] = x if e == 0 else self.f2_mul_const(x, gf._GAMMA_POWERS[e])
        return (tuple(out[0]), tuple(out[1]))

    def f12_frobenius2(self, a):
        """frob(frob(a)): coefficient k times the norm of gamma^k (in Fp),
        2 products each."""
        out = [[None] * 3, [None] * 3]
        for h in range(2):
            for j in range(3):
                e = 2 * j + h
                g = gf._GAMMA_POWERS[e]
                out[h][j] = self.f2_mul_fp(a[h][j], self.F.const(g[0] * g[0] + g[1] * g[1]))
        return (tuple(out[0]), tuple(out[1]))

    def f12_mul_by_line(self, f, line):
        """f ((c00, 0, 0) + (0, c11, c12) w): 14 Fp2 products."""
        c00, c11, c12 = line
        t0 = self.f6_mul_fp2(f[0], c00)
        t1 = self.f6_mul_sparse01(f[1], c11, c12)
        s = self.f6_mul(self.f6_add(f[0], f[1]), (c00, c11, c12))
        return (self.f6_add(t0, self.f6_mul_by_v(t1)), self.f6_sub(s, self.f6_add(t0, t1)))

    def f12_inv(self, a):
        """golden/field.py fp12_inv: down to one Fp inversion by norms."""
        norm = self.f6_sub(self.f6_mul(a[0], a[0]), self.f6_mul_by_v(self.f6_mul(a[1], a[1])))
        ninv = self.f6_inv(norm)
        return (self.f6_mul(a[0], ninv), self.f6_neg(self.f6_mul(a[1], ninv)))

    # -- G2 (T projective over Fp2) and lines --
    def g2_dbl_tangent(self, t, xp, yp):
        """(the RCB doubling of t, the tangent at t scaled by 2YZ^2): the
        polynomials of the JAX _g2_double and tangent_line_coeffs (b3 =
        12 xi), each small multiple moved onto an operand of a product so
        that it is formed before the first level of products: b3 Z^2 =
        (b3 Z) Z, 3 b3 Z^2 = (3 b3 Z) Z, 8 Y^2, 2 X Y = (2X) Y; c00 = xi
        (YZ) (Z 2yP), c11 = X^2 (3X) - Y^2 (2Z), c12 = X^2 (Z (-3xP))."""
        F = self.F
        x, y, z = t
        zb = self.f2_small(self.f2_mul_xi(z), 12)  # b3 Z
        t2, t2x3 = self.f2_mul(zb, z), self.f2_mul(zb, self.f2_small(z, 3))
        yy = self.f2_sqr(y)
        z3 = (F.mul(self._small(F.add(y[0], y[1]), 8), F.sub(y[0], y[1])), F.mul(self._small(y[0], 16), y[1]))  # 8 Y^2
        yz, xy2 = self.f2_mul(y, z), self.f2_mul(self.f2_small(x, 2), y)
        xx = self.f2_sqr(x)
        c00 = self.f2_mul_xi(self.f2_mul(yz, self.f2_mul_fp(z, self._small(yp, 2))))
        c11 = self.f2_sub(self.f2_mul(xx, self.f2_small(x, 3)), self.f2_mul(yy, self.f2_small(z, 2)))
        c12 = self.f2_mul(xx, self.f2_mul_fp(z, F.neg(self._small(xp, 3))))
        y3 = self.f2_add(yy, t2)
        t0 = self.f2_sub(yy, t2x3)
        dbl = (self.f2_mul(t0, xy2), self.f2_add(self.f2_mul(t2, z3), self.f2_mul(t0, y3)), self.f2_mul(yz, z3))
        return dbl, (c00, c11, c12)

    def g2_madd_chord(self, t, q, xp, yp):
        """(t + q by the RCB mixed add, the chord through t and q scaled by
        D = x2 Z - X): the JAX _g2_madd and chord_line_coeffs, sharing
        x2 Z and y2 Z, b3 = 12 xi by additions."""
        x1, y1, z1 = t
        x2, y2 = q
        y2z, x2z = self.f2_mul(y2, z1), self.f2_mul(x2, z1)
        nn, dd = self.f2_sub(y2z, y1), self.f2_sub(x2z, x1)
        c00 = self.f2_mul_xi(self.f2_mul_fp(dd, yp))
        c11 = self.f2_sub(self.f2_mul(nn, x2), self.f2_mul(y2, dd))
        c12 = self.f2_mul_fp(nn, self.F.neg(xp))
        t0, t1 = self.f2_mul(x1, x2), self.f2_mul(y1, y2)
        t3 = self.f2_sub(self.f2_mul(self.f2_add(x1, y1), self.f2_add(x2, y2)), self.f2_add(t0, t1))
        t4 = self.f2_add(y2z, y1)
        t5 = self.f2_add(x2z, x1)
        three_t0 = self.f2_small(t0, 3)
        bt2 = self.f2_small(self.f2_mul_xi(z1), 12)
        z3t, t1m = self.f2_add(t1, bt2), self.f2_sub(t1, bt2)
        y3t = self.f2_small(self.f2_mul_xi(t5), 12)
        add = (
            self.f2_sub(self.f2_mul(t3, t1m), self.f2_mul(t4, y3t)),
            self.f2_add(self.f2_mul(y3t, three_t0), self.f2_mul(t1m, z3t)),
            self.f2_add(self.f2_mul(z3t, t4), self.f2_mul(three_t0, t3)),
        )
        return add, (c00, c11, c12)

    def miller_step(self, f, t, q, xp, yp, bit: int):
        """One step of the Miller loop (the JAX miller_step with the bit):
        f^2 times the tangent line, T doubled; with the bit, times the
        chord line and T + Q."""
        t, line = self.g2_dbl_tangent(t, xp, yp)
        f = self.f12_mul_by_line(self.f12_sqr(f), line)
        if bit:
            t, line = self.g2_madd_chord(t, q, xp, yp)
            f = self.f12_mul_by_line(f, line)
        return f, t


# ---------------------------------------------------------------------------
# Frames and programs
# ---------------------------------------------------------------------------

# Registers of each kernel's frame, in Fp slots, from slot 0: P1's
# operands and result; P2's Miller value F, the point T (X, Y, Z over
# Fp2), Q (x2, y2) and P (xp, yp); P3's Fp12 values.
FRAMES = {
    "p1": (("A", 12), ("B", 12), ("Z", 12)),
    "p2": (("F", 12), ("T", 6), ("Q", 4), ("P", 2)),
    "p3": (("M", 12), ("U", 12), ("W1", 12), ("ACC", 12), ("ALT", 12), ("BASE", 12)),
}


def _shape(n: int):
    """The nesting of n Fp slots: 2 (Fp2), 4 (two Fp2), 6 (three Fp2, an
    Fp6 or a G2 point), 12 (Fp12)."""
    return {2: (2,), 4: (2, 2), 6: (3, 2), 12: (2, 3, 2)}[n]


def nest(flat, shape):
    """A flat list -> nested tuples of ``shape``."""
    if len(shape) == 1:
        return tuple(flat)
    step = len(flat) // shape[0]
    return tuple(nest(flat[i * step : (i + 1) * step], shape[1:]) for i in range(shape[0]))


def flatten(x) -> list:
    if isinstance(x, tuple):
        return [v for p in x for v in flatten(p)]
    return [x]


def register_slots(frame: str) -> dict[str, tuple[int, int]]:
    """Register -> (first slot, slots)."""
    out, at = {}, 0
    for name, n in FRAMES[frame]:
        out[name] = (at, n)
        at += n
    return out


def _p1_programs(tw, reg):
    a = reg("A")
    return {
        "mul": {"Z": tw.f12_mul(a, reg("B"))},
        "sqr": {"Z": tw.f12_sqr(a)},
        "cyclo_sqr": {"Z": tw.f12_cyclo_sqr(a)},
        "frobenius": {"Z": tw.f12_frobenius(a)},
        "inv": {"Z": tw.f12_inv(a)},
        "mul_by_line": {"Z": tw.f12_mul_by_line(a, nest(flatten(reg("B"))[:6], (3, 2)))},
    }


def _p2_programs(tw, reg):
    f, t, q, p = reg("F"), reg("T"), reg("Q"), reg("P")
    out = {}
    for name, bit in (("dbl", 0), ("dbl_add", 1)):
        f2, t2 = tw.miller_step(f, t, q, p[0], p[1], bit)
        out[name] = {"F": f2, "T": t2}
    return out


def _p3_programs(tw, reg):
    """The final exponentiation's parts around the five exponentiations by
    x (the JAX _easy_part_kernel, _final_exp_hard_chain and
    _hard_tail_expr): the kernel runs ``sqr`` on every bit and ``mul`` on
    the set ones, and each part leaves the next exponentiation's base in
    ACC and BASE.  The two Miller values come in U and W1; the value
    leaves in U."""
    m, u, w1, acc = reg("M"), reg("U"), reg("W1"), reg("ACC")
    e = tw.f12_conj(acc)  # an exponentiation's result, conj(acc)
    x = tw.f12_mul(u, w1)
    em = tw.f12_mul(tw.f12_conj(x), tw.f12_inv(x))
    em = tw.f12_mul(tw.f12_frobenius2(em), em)
    u1 = tw.f12_mul(e, tw.f12_conj(m))  # m^(x-1)
    u2 = tw.f12_mul(e, tw.f12_conj(u))  # m^((x-1)^2)
    w = tw.f12_mul(e, tw.f12_frobenius(u))  # ^(x+p)
    # Tail, e5 frob^2(w1) conj(w1) m^3: ACC = e5 frob^2(w1), BASE =
    # conj(w1) m, BASE = BASE cyclo_sqr(m), then U = ACC BASE.
    return {
        "easy": {"M": em, "ACC": em, "BASE": em},
        "sqr": {"ALT": tw.f12_cyclo_sqr(acc)},
        "sqr_alt": {"ACC": tw.f12_cyclo_sqr(reg("ALT"))},
        "mul": {"ALT": tw.f12_mul(acc, reg("BASE"))},
        "mul_alt": {"ACC": tw.f12_mul(reg("ALT"), reg("BASE"))},
        "alt": {"ACC": reg("ALT")},
        "hard1": {"U": u1, "ACC": u1, "BASE": u1},
        "hard2": {"U": u2, "ACC": u2, "BASE": u2},
        "hard3": {"W1": w, "ACC": w, "BASE": w},
        "hard4": {"ACC": e, "BASE": e},
        "tail1": {"ACC": tw.f12_mul(e, tw.f12_frobenius2(w1))},
        "tail2": {"BASE": tw.f12_mul(tw.f12_conj(w1), m)},
        "tail3": {"BASE": tw.f12_mul(reg("BASE"), tw.f12_cyclo_sqr(m))},
        "tail4": {"U": tw.f12_mul(acc, reg("BASE"))},
    }


def p2_sequence() -> list[str]:
    """P2's programs in order: a step a bit of |x| below its MSB."""
    return ["dbl_add" if bit else "dbl" for bit in X_BITS]


def p3_sequence(bits) -> list[str]:
    """P3's programs in order for exponent ``bits`` (MSB first below the
    leading one): the easy part, five exponentiations by x (a squaring a
    bit, a product a set bit, each from ACC to ALT or back, and ``alt``
    where one ends in ALT) with the hard chain's parts between them, and
    the tail."""
    seq = ["easy"]
    for k in range(5):
        in_alt = False
        for bit in bits:
            for op in ("sqr", "mul") if bit else ("sqr",):
                seq.append(op + "_alt" if in_alt else op)
                in_alt = not in_alt
        if in_alt:
            seq.append("alt")
        seq += [("hard1",), ("hard2",), ("hard3",), ("hard4",), ("tail1", "tail2", "tail3", "tail4")][k]
    return seq


KERNEL_PROGRAMS = {"p1": _p1_programs, "p2": _p2_programs, "p3": _p3_programs}


class Program:
    """One scheduled program: ``levels`` is a list of (kind, ops), an op
    (code, dst, na, nb, terms) over frame slots with ``terms`` a list of
    (slot, +-1): a product dst = a b (na = nb = 1), a linear op dst = a +-
    b +- c (na = 3, a's coefficient 1), or an inversion dst = a^(p-2)."""

    def __init__(self, name: str, levels: list, slots: int):
        self.name, self.levels, self.slots = name, levels, slots

    def count(self, kind: int) -> int:
        return sum(len(ops) for k, ops in self.levels if k == kind)

    def level_counts(self) -> list[tuple[str, int]]:
        return [("PLI"[kind], len(ops)) for kind, ops in self.levels]


class _Node:
    """An operation of a scheduled program, "mul", "lin" or "inv", over
    forms (tuples of (node, +-1): a product's and an inversion's hold one
    node each, a linear op's up to three), or a leaf "in" / "const"; ``at``
    is its (stage, sublevel)."""

    __slots__ = ("op", "forms", "id", "value", "at")

    def __init__(self, op, forms, ident, value, at):
        self.op, self.forms, self.id, self.value, self.at = op, forms, ident, value, at

    @property
    def args(self):
        return [n for form in self.forms for n, _ in form]


class _Rebuild:
    """The trace's operations that some outputs need, with every chain of
    additions and subtractions between products expanded into one linear
    form (integer coefficients) over products, inputs, constants and the
    sums that several operations read (INLINE_TERMS).  A product takes a
    node for each operand; a linear op sums up to SUM_TERMS terms of
    coefficient +-1 (a multiple is its term repeated), and longer sums
    take a linear op at a time, the earliest-ready terms first."""

    def __init__(self, trace: _Trace, outs: list[Val]):
        self.trace = trace
        self.uses = _uses(outs)
        self.nodes: list[_Node] = []  # operations, topological
        self._memo: dict = {}
        self._conv: dict[int, _Node] = {}
        self._exp: dict[int, dict] = {}
        self.zero = self._leaf("const", 0)

    def _leaf(self, op, value):
        key = (op, value)
        n = self._memo.get(key)
        if n is None:
            n = self._memo[key] = _Node(op, (), len(self._memo), value, (0, 0))
        return n

    def _make(self, op, forms):
        key = (op,) + tuple(tuple((n.id, c) for n, c in f) for f in forms)
        n = self._memo.get(key)
        if n is None:
            nodes = [x for f in forms for x, _ in f]
            if op == "lin":
                s = max(x.at[0] for x in nodes)
                at = (s, 1 + max((x.at[1] for x in nodes if x.at[0] == s), default=0))
            else:
                at = (1 + max(x.at[0] for x in nodes), 0)
            n = self._memo[key] = _Node(op, tuple(forms), len(self._memo), None, at)
            self.nodes.append(n)
        return n

    def _expand(self, v: Val, top: bool = True) -> dict:
        """v as {trace value id: integer coefficient} over products,
        inputs, constants and shared sums (v linear).  A linear operand
        that several operations read and that sums more than INLINE_TERMS
        terms stays whole: its sum is formed once."""
        if not top and v.op in ("add", "sub") and self.uses.get(v.id, 0) > 1 and len(self._expand(v)) > INLINE_TERMS:
            return {v.id: 1}
        e = self._exp.get(v.id)
        if e is None:
            if v.op in ("add", "sub"):
                e = dict(self._expand(v.args[0], False))
                sign = 1 if v.op == "add" else -1
                for k, c in self._expand(v.args[1], False).items():
                    e[k] = e.get(k, 0) + sign * c
                e = {k: c for k, c in e.items() if c}
            else:
                e = {v.id: 1}
            self._exp[v.id] = e
        return e

    def _terms(self, v: Val) -> list:
        """v's expansion as (node, +-1) terms, the constants folded into
        one, a term of coefficient c repeated |c| times."""
        terms, const = [], 0
        for k, c in self._expand(v).items():
            leaf = self.trace.vals[k]
            if leaf.op == "const":
                const += c * leaf.value
                continue
            n = self.convert(leaf) if leaf.op not in ("add", "sub") else self._sum(leaf)
            terms += [(n, 1 if c > 0 else -1)] * abs(c)
        if const % P:
            terms.append((self._leaf("const", const % P), 1))
        return terms

    def _reduce(self, terms: list, limit: int) -> list:
        """terms summed a linear op at a time (up to SUM_TERMS terms, the
        earliest ready first) until at most ``limit`` remain."""
        terms = sorted(terms, key=lambda t: t[0].at)
        while len(terms) > limit:
            k = min(SUM_TERMS, len(terms) - limit + 1)
            group, terms = terms[:k], terms[k:]
            terms = sorted(terms + [self._lin(group)], key=lambda t: t[0].at)
        return terms

    def _lin(self, terms) -> tuple:
        """A linear op over up to three terms of coefficient +-1 -> (its
        node, the sign its value enters with): three negative terms are
        summed positive and enter negated (an op's first term is positive,
        or the constant 0 goes first)."""
        if len(terms) == SUM_TERMS and all(c < 0 for _, c in terms):
            return self._make("lin", [_form([(n, -c) for n, c in terms])]), -1
        return self._make("lin", [_form(terms)]), 1

    def _node_of(self, terms) -> _Node:
        """The node holding the sum of up to three terms."""
        if not terms:
            return self.zero
        if len(terms) == 1 and terms[0][1] == 1:
            return terms[0][0]
        node, sign = self._lin(terms)
        return node if sign > 0 else self._make("lin", [((node, -1),)])

    def _sum(self, v: Val) -> _Node:
        """The node holding linear value v."""
        n = self._conv.get(v.id)
        if n is None:
            n = self._conv[v.id] = self._node_of(self._reduce(self._terms(v), SUM_TERMS))
        return n

    def operand(self, v: Val) -> tuple:
        """v as a product's operand: the form of one node."""
        return ((self.convert(v) if v.op not in ("add", "sub") else self._sum(v), 1),)

    def convert(self, v: Val) -> _Node:
        """The node of trace value v."""
        n = self._conv.get(v.id)
        if n is None:
            if v.op == "in":
                n = self._leaf("in", v.value)
            elif v.op == "const":
                n = self._leaf("const", v.value)
            elif v.op == "mul":
                n = self._make("mul", sorted((self.operand(a) for a in v.args), key=lambda f: [(x.id, c) for x, c in f]))
            elif v.op == "inv":
                n = self._make("inv", [((self.convert(v.args[0]) if v.args[0].op not in ("add", "sub") else self._sum(v.args[0]), 1),)])
            else:
                n = self._sum(v)
            self._conv[v.id] = n
        return n


def prepare(name: str, frame: str, trace: _Trace, outputs: dict):
    """A traced program's operations: (rebuild, pins [(slot, node)], the
    operations the pins need, topological)."""
    regs = register_slots(frame)
    rb = _Rebuild(trace, [v for value in outputs.values() for v in flatten(value)])
    pins = []
    for reg, value in outputs.items():
        first, n = regs[reg]
        flat = flatten(value)
        assert len(flat) == n, (name, reg)
        pins += [(first + k, rb.convert(v)) for k, v in enumerate(flat)]
    return rb, pins, _needed(rb.nodes, [n for _, n in pins])


def schedule(name: str, prepared, const_slot: dict, scratch_base: int) -> Program:
    """Levels and slots of one prepared program; ``const_slot`` constant
    value -> slot."""
    rb, pins, ops = prepared
    key = _level_keys(ops)
    keys = sorted(set(key.values()))
    index = {k: i for i, k in enumerate(keys)}
    level = {n.id: index[key[n.id]] for n in ops}
    kinds = [None] * len(keys)
    for n in ops:
        kinds[level[n.id]] = {"mul": LEVEL_MUL, "inv": LEVEL_INV, "lin": LEVEL_LIN}[n.op]
    last_use: dict[int, int] = {}
    for n in ops:
        for a in n.args:
            last_use[a.id] = max(last_use.get(a.id, -1), level[n.id])
    # Outputs: each computed value goes straight into its register slot if
    # the register's old value is dead by then; else it is copied there in
    # a linear level appended at the end.
    slot_of: dict[int, int] = {}
    copies = []
    for slot, n in pins:
        if n.op == "in" and n.value == slot:
            continue
        old = rb._memo.get(("in", slot))
        old_dead = old is None or last_use.get(old.id, -1) < level.get(n.id, -1)
        if n.op not in ("in", "const") and n.id not in slot_of and old_dead:
            slot_of[n.id] = slot
        else:
            copies.append((slot, n))
    if copies:
        kinds.append(LEVEL_LIN)
        for _, n in copies:
            last_use[n.id] = len(keys)
    nlev = len(kinds)
    for n in rb._memo.values():
        if n.op == "in":
            slot_of[n.id] = n.value
        elif n.op == "const":
            slot_of[n.id] = const_slot[n.value]
    # Scratch: a slot is free again the level after its value's last use.
    by_level: list[list[_Node]] = [[] for _ in range(nlev)]
    for n in ops:
        by_level[level[n.id]].append(n)
    free, top, frees_at = [], scratch_base, {}
    for n in ops:
        if n.id not in slot_of:
            frees_at.setdefault(last_use.get(n.id, level[n.id]) + 1, []).append(n)
    for lev in range(nlev):
        for n in frees_at.get(lev, []):
            free.append(slot_of[n.id])
        free.sort(reverse=True)
        for n in by_level[lev]:
            if n.id in slot_of:
                continue
            slot_of[n.id] = free.pop() if free else top
            if slot_of[n.id] == top:
                top += 1
    assert top <= MAX_SLOTS, (name, top)
    levels = []
    for lev in range(nlev):
        lops = []
        for n in by_level[lev]:
            forms = [[(slot_of[x.id], c) for x, c in f] for f in n.forms]
            code = {"mul": OP_MUL, "lin": OP_LIN, "inv": OP_INV}[n.op]
            lops.append((code, slot_of[n.id], len(forms[0]), len(forms[1]) if len(forms) > 1 else 0, forms[0] + (forms[1] if len(forms) > 1 else [])))
        if lev == nlev - 1 and copies:
            lops += [(OP_LIN, slot, 1, 0, [(slot_of[n.id], 1)]) for slot, n in copies]
        zero = const_slot[0]
        lops = [op if op[0] != OP_LIN else _three(op, zero) for op in lops]
        lops.sort(key=lambda op: (tuple(c for _, c in op[4]), op[1]))  # like signs side by side
        levels.append((kinds[lev], lops))
    return Program(name, levels, top)


def _three(op, zero: int):
    """A linear op's terms as a +- b +- c: the first positive (the
    constant 0 where none is), padded with + 0."""
    code, dst, na, nb, terms = op
    if terms[0][1] < 0:
        terms = [(zero, 1)] + list(terms)
    terms = list(terms) + [(zero, 1)] * (SUM_TERMS - len(terms))
    assert len(terms) == SUM_TERMS and terms[0][1] == 1
    return (code, dst, SUM_TERMS, 0, terms)


def _form(terms) -> tuple:
    """A linear form's terms in the kernels' order: the positive ones
    first."""
    return tuple(sorted(terms, key=lambda t: (-t[1], t[0].id)))


def _uses(outs: list[Val]) -> dict[int, int]:
    """Trace value id -> the operations (and outputs) that read it, over
    what ``outs`` need."""
    uses, seen, stack = {}, set(), list(outs)
    for v in outs:
        uses[v.id] = uses.get(v.id, 0) + 1
    while stack:
        v = stack.pop()
        if v.id in seen:
            continue
        seen.add(v.id)
        for a in v.args:
            uses[a.id] = uses.get(a.id, 0) + 1
            stack.append(a)
    return uses


def _needed(nodes: list[_Node], outs: list[_Node]) -> list[_Node]:
    """The operations of ``nodes`` (topological) that ``outs`` need."""
    need = {n.id for n in outs}
    for n in reversed(nodes):
        if n.id in need:
            need.update(a.id for a in n.args)
    return [n for n in nodes if n.id in need]


def _level_keys(ops: list[_Node]) -> dict[int, tuple]:
    """Each operation's level as (stage, kind, sublevel): products and the
    inversion at their stage (one after their last product operand); the
    linear operations in the region after the products of some stage r, in
    sublevels by their chains there.  Region r holds what the products of
    stage r + 1 need, in as few sublevels as their chains take, and
    whatever else fits in those sublevels; the rest waits for a later
    region (so a long chain that no product needs soon does not hold the
    next products back)."""
    stage = {n.id: n.at[0] for n in ops if n.op != "lin"}
    last = max(stage.values(), default=0)
    key = {n.id: (stage[n.id], 0 if n.op == "mul" else 1, 0) for n in ops if n.op != "lin"}
    by_stage: dict[int, list[_Node]] = {}
    for n in ops:
        if n.op != "lin":
            by_stage.setdefault(stage[n.id], []).append(n)
    pending = [n for n in ops if n.op == "lin"]
    for r in range(last + 1):
        if r == last:
            need = {n.id for n in pending}
        else:
            need, stack = set(), [a for n in by_stage.get(r + 1, []) for a in n.args if a.op == "lin"]
            while stack:
                x = stack.pop()
                if x.id not in key and x.id not in need:
                    need.add(x.id)
                    stack += [a for a in x.args if a.op == "lin"]
        sub: dict[int, int] = {}
        for n in pending:
            if n.id in need:
                sub[n.id] = 1 + max((sub[a.id] for a in n.args if a.id in sub), default=0)
        depth = max(sub.values(), default=0)
        for n in pending:
            if n.id in need or not all(a.id in sub or (a.id in key and (a.op == "lin" or stage[a.id] <= r)) or a.op in ("in", "const") for a in n.args):
                continue
            level = 1 + max((sub[a.id] for a in n.args if a.id in sub), default=0)
            if level <= depth:
                sub[n.id] = level
        for i, v in sub.items():
            key[i] = (r, 2, v)
        pending = [n for n in pending if n.id not in sub]
    assert not pending
    return key


def build() -> dict:
    """Every kernel's programs, scheduled: {kernel: {"programs": {name:
    Program}, "consts": [value, ...], "const_base": slot, "slots": n,
    "registers": {name: (first slot, slots)}}}."""
    out = {}
    for kernel, make in KERNEL_PROGRAMS.items():
        regs = register_slots(kernel)
        nregs = sum(n for _, n in FRAMES[kernel])
        tr = _Trace()

        def reg(r):
            first, n = regs[r]
            return nest([tr.input(first + k) for k in range(n)], _shape(n))

        traced = make(_Tower(tr), reg)
        prepared = {name: prepare(name, kernel, tr, outputs) for name, outputs in traced.items()}
        consts = {0}  # negations and copies
        for _, _, ops in prepared.values():
            consts |= {a.value for n in ops for a in n.args if a.op == "const"}
        clist = sorted(consts)
        const_slot = {c: nregs + i for i, c in enumerate(clist)}
        base = nregs + len(clist)
        programs = {name: schedule(name, prep, const_slot, base) for name, prep in prepared.items()}
        out[kernel] = {
            "programs": programs,
            "consts": clist,
            "const_base": nregs,
            "slots": max(p.slots for p in programs.values()),
            "registers": regs,
        }
    return out


# ---------------------------------------------------------------------------
# Running a program on Python ints
# ---------------------------------------------------------------------------


def execute(prog: Program, frame: list[int]) -> None:
    """Run ``prog`` over ``frame`` (plain Fp ints by slot, in place) as the
    kernels do: each level reads its operands before any of its writes
    land; a level whose operations write one slot twice, or read a slot
    that another of its operations writes, raises."""
    for kind, ops in prog.levels:
        writes = [op[1] for op in ops]
        if len(set(writes)) != len(writes) or {slot for op in ops for slot, _ in op[4]} & set(writes):
            raise AssertionError(f"{prog.name}: a level's operations are not independent")
        vals = []
        for code, dst, na, nb, terms in ops:
            x = sum(c * frame[slot] for slot, c in terms[:na]) % P
            if code == OP_MUL:
                vals.append(x * sum(c * frame[slot] for slot, c in terms[na:]) % P)
            elif code == OP_LIN:
                vals.append(x)
            else:
                vals.append(pow(x, P - 2, P))
        for op, v in zip(ops, vals):
            frame[op[1]] = v


def encode(op) -> list[int]:
    """An op as the two words of pairing_programs.cuh's kOps: code << 30 |
    b << 20 | a << 10 | dst, then sc << 11 | sb << 10 | c: a product dst =
    a b, a linear op dst = a + (-1)^sb b + (-1)^sc c, an inversion dst =
    a^(p-2)."""
    code, dst, na, nb, terms = op
    slots = [slot for slot, _ in terms] + [0] * (3 - len(terms))
    signs = [int(c < 0) for _, c in terms[1:3]] + [0] * (3 - len(terms))
    assert all(0 <= x < MAX_SLOTS for x in slots + [dst]) and all(abs(c) == 1 for _, c in terms) and terms[0][1] == 1
    return [code << 30 | slots[1] << 20 | slots[0] << 10 | dst, signs[1] << 11 | signs[0] << 10 | slots[2]]


def decode(words: list[int]):
    """The op of two kOps words (encode's inverse)."""
    x, y = words
    code, dst, a, b, c = x >> 30, x & 1023, x >> 10 & 1023, x >> 20 & 1023, y & 1023
    if code == OP_LIN:
        return (code, dst, 3, 0, [(a, 1), (b, -1 if y >> 10 & 1 else 1), (c, -1 if y >> 11 & 1 else 1)])
    if code == OP_MUL:
        return (code, dst, 1, 1, [(a, 1), (b, 1)])
    return (code, dst, 1, 0, [(a, 1)])


def new_frame(kernel: str, built: dict) -> list[int]:
    """A frame of ``kernel`` with its constants in place (plain ints)."""
    k = built[kernel]
    frame = [0] * k["slots"]
    for i, c in enumerate(k["consts"]):
        frame[k["const_base"] + i] = c
    return frame


# ---------------------------------------------------------------------------
# The header the kernels read
# ---------------------------------------------------------------------------


def _mont_words(v: int) -> list[int]:
    m = v * (1 << 384) % P
    return [(m >> (32 * j)) & 0xFFFFFFFF for j in range(12)]


def _c_words(words: list[int], per_line: int = 6, indent: str = "    ") -> str:
    lines = []
    for i in range(0, len(words), per_line):
        lines.append(indent + ", ".join(f"0x{w:08x}u" for w in words[i : i + per_line]) + ",")
    return "\n".join(lines)


def header_text(built: dict | None = None) -> str:
    built = built or build()
    ops, levels, prog_first, names = [], [], [], []
    const_words, const_first = [], {}
    frame_lines = []
    for kernel, k in built.items():
        const_first[kernel] = len(const_words) // 12
        for c in k["consts"]:
            const_words += _mont_words(c)
        regs = ", ".join(f"{name} = {first}" for name, (first, _) in k["registers"].items())
        frame_lines.append(
            f"// {kernel.upper()}: registers {regs}; {len(k['consts'])} constants from slot {k['const_base']}; "
            f"{k['slots']} slots ({k['slots'] * 48} bytes) a group."
        )
        frame_lines.append(
            f"constexpr int k{kernel.upper()}Slots = {k['slots']}, k{kernel.upper()}ConstBase = {k['const_base']}, "
            f"k{kernel.upper()}Consts = {len(k['consts'])}, k{kernel.upper()}ConstFirst = {const_first[kernel]};"
        )
        for r, (first, _) in k["registers"].items():
            frame_lines.append(f"constexpr int k{kernel.upper()}Reg{r} = {first};")
        for name, prog in k["programs"].items():
            names.append(f"k{kernel.upper()}{''.join(p.capitalize() for p in name.split('_'))}")
            prog_first.append(len(levels))
            for kind, lops in prog.levels:
                levels.append(len(ops) // 2 << 2 | kind)
                for op in lops:
                    ops += encode(op)
    prog_first.append(len(levels))
    levels.append(len(ops) // 2 << 2)
    lines = [
        "// The device pairing's programs: generated by kzg_rust_tpu_torch/ops/pairing_programs.py",
        "// (header_text, written by ops/_build.py at build time).  Each program is a",
        "// range of kLevels (a level: its first operation << 2 | its kind, 0 products, 1 linear,",
        "// 2 an inversion; it ends where the next begins), each operation two words of kOps over",
        "// Fp slots of the group's frame: x = code << 30 | b << 20 | a << 10 | dst, y = sc << 11 |",
        "// sb << 10 | c (code 0: dst = a b; 1: dst = a + (-1)^sb b + (-1)^sc c; 2: dst = a^(p-2)).",
        "// kConstWords: each kernel's constants, Montgomery words.",
        "",
        "#pragma once",
        "",
        "#include <cuda_runtime.h>",
        "",
        "#include <cstdint>",
        "",
        "namespace kzg {",
        "",
        *frame_lines,
        "",
        "enum Program {",
        *[f"  {n} = {i}," for i, n in enumerate(names)],
        "};",
        f"constexpr int kPrograms = {len(names)};",
        "",
        f"__constant__ uint32_t kProgramLevel[{len(prog_first)}] = {{",
        _c_ints(prog_first),
        "};",
        f"__constant__ uint32_t kLevels[{len(levels)}] = {{",
        _c_ints(levels),
        "};",
        f"__device__ const uint2 kOps[{len(ops) // 2}] = {{",
        _c_words(ops),
        "};",
        f"__device__ const uint32_t kConstWords[{len(const_words)}] = {{",
        _c_words(const_words),
        "};",
        "",
        "}  // namespace kzg",
        "",
    ]
    return "\n".join(lines)


def _c_ints(values: list[int], per_line: int = 12) -> str:
    return "\n".join("    " + ", ".join(str(v) for v in values[i : i + per_line]) + "," for i in range(0, len(values), per_line))


def summary(built: dict | None = None) -> str:
    """Each program's levels (kind and operations a level), for the
    source note and PERF.md."""
    built = built or build()
    lines = []
    for kernel, k in built.items():
        for name, prog in k["programs"].items():
            counts = " ".join(f"{kind}{n}" for kind, n in prog.level_counts())
            lines.append(f"{kernel} {name}: {len(prog.levels)} levels ({sum(1 for kd, _ in prog.levels if kd == LEVEL_MUL)} of products), {prog.count(LEVEL_MUL)} products, {prog.count(LEVEL_LIN)} linear: {counts}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(summary())
