"""Unit tests: device extension tower + pairing vs the golden oracle."""

from __future__ import annotations

import random

import numpy as np
import pytest

from kzg_rust_tpu.golden import curve as gc
from kzg_rust_tpu.golden import field as gf
from kzg_rust_tpu.golden import pairing as gp
from kzg_rust_tpu.ops import pairing as dp
from kzg_rust_tpu.ops import tower as T2

rng = random.Random(0xE11)


def rand_fp2():
    return (rng.randrange(gf.P), rng.randrange(gf.P))


def rand_fp12():
    return (
        (rand_fp2(), rand_fp2(), rand_fp2()),
        (rand_fp2(), rand_fp2(), rand_fp2()),
    )


def test_fp12_ops_match_golden():
    a, b = rand_fp12(), rand_fp12()
    da, db = T2.fp12_from_golden(a), T2.fp12_from_golden(b)
    assert T2.fp12_to_golden(T2.fp12_mul(da, db)) == gf.fp12_mul(a, b)
    assert T2.fp12_to_golden(T2.fp12_sqr(da)) == gf.fp12_sqr(a)
    assert T2.fp12_to_golden(T2.fp12_inv(da)) == gf.fp12_inv(a)
    assert T2.fp12_to_golden(T2.fp12_frobenius(da)) == gf.fp12_frobenius(a)
    # cyclotomic squaring on a unit-norm element
    t = gf.fp12_mul(gf.fp12_conj(a), gf.fp12_inv(a))
    t = gf.fp12_mul(gf.fp12_frobenius_n(t, 2), t)
    dt = T2.fp12_from_golden(t)
    assert T2.fp12_to_golden(T2.fp12_cyclo_sqr(dt)) == gf.fp12_cyclo_sqr(t)


_cpu_backend = None


def _on_cpu() -> bool:
    global _cpu_backend
    if _cpu_backend is None:
        import jax

        _cpu_backend = jax.default_backend() == "cpu"
    return _cpu_backend


# ---------------------------------------------------------------------------
# CPU-runnable stage tests (VERDICT round-2 item 6): every piece of the
# device pairing individually vs golden, so the Miller/final-exp math has an
# off-TPU correctness gate.  Only the full 63-step scans stay TPU-only.
# ---------------------------------------------------------------------------


def _fp2_to_golden(c):
    from kzg_rust_tpu.ops import limbs as L
    from kzg_rust_tpu.ops.fields import FP

    def one(v):
        v = np.asarray(L.from_mont(FP, v))
        if v.ndim == 2:  # batched: all lanes identical by construction
            v = v[0]
        return L.limbs_to_int(v)

    return (one(c[0]), one(c[1]))


def _fp12_to_golden_b(x):
    return tuple(tuple(_fp2_to_golden(c) for c in h) for h in x)


def _sparse_line_fp12(c00, c11, c12):
    return ((c00, gf.FP2_ZERO, gf.FP2_ZERO), (gf.FP2_ZERO, c11, c12))


def test_fp12_mul_by_line_matches_golden():
    f = rand_fp12()
    c00, c11, c12 = rand_fp2(), rand_fp2(), rand_fp2()
    df = T2.fp12_from_golden(f, shape=(2,))
    got = dp.fp12_mul_by_line(
        df,
        T2.fp2_from_golden(c00, (2,)),
        T2.fp2_from_golden(c11, (2,)),
        T2.fp2_from_golden(c12, (2,)),
    )
    want = gf.fp12_mul(f, _sparse_line_fp12(c00, c11, c12))
    assert _fp12_to_golden_b(got) == want


def _rand_proj_g2(k: int):
    """Projective G2 point [k]G2 with a random Z scale, golden ints."""
    x, y = gc.g2_mul(gc.G2_GENERATOR, k)
    s = rand_fp2()
    return (gf.fp2_mul(x, s), gf.fp2_mul(y, s), s), (x, y)


def _g2_norm(t):
    x, y, z = t
    zi = gf.fp2_inv(z)
    return (gf.fp2_mul(x, zi), gf.fp2_mul(y, zi))


def _to_dev_g2(t):
    return tuple(T2.fp2_from_golden(c, (2,)) for c in t)


@pytest.mark.slow
def test_g2_projective_steps_match_golden():
    """Device RCB double / mixed-add over Fp2 == golden affine arithmetic
    (independent of the formulas under test: golden uses slopes)."""
    import jax

    t, t_aff = _rand_proj_g2(5)
    q = gc.g2_mul(gc.G2_GENERATOR, 9)
    dbl = jax.jit(dp._g2_double)(_to_dev_g2(t))
    got_dbl = _g2_norm(tuple(_fp2_to_golden(c) for c in dbl))
    assert got_dbl == gc.g2_add(t_aff, t_aff)
    madd = jax.jit(dp._g2_madd)(
        _to_dev_g2(t), (T2.fp2_from_golden(q[0], (2,)), T2.fp2_from_golden(q[1], (2,)))
    )
    got_madd = _g2_norm(tuple(_fp2_to_golden(c) for c in madd))
    assert got_madd == gc.g2_add(t_aff, q)


def test_line_coeffs_proportional_to_golden_line():
    """The device's denominator-scaled tangent line == the golden affine
    line (golden/pairing.py:46-58) times the Fp2 factor 2YZ^2 — projectively
    the same line, and the factor is annihilated by the final
    exponentiation."""
    import jax

    p_g1 = gc.g1_mul(gc.G1_GENERATOR, 7)
    t, t_aff = _rand_proj_g2(5)
    xp_m, yp_m = _g1_mont(p_g1)
    c = jax.jit(dp.tangent_line_coeffs)(_to_dev_g2(t), xp_m, yp_m)
    got = tuple(_fp2_to_golden(cc) for cc in c)

    x1, y1 = t_aff
    lam = gf.fp2_mul(
        gf.fp2_mul_fp(gf.fp2_sqr(x1), 3), gf.fp2_inv(gf.fp2_mul_fp(y1, 2))
    )
    gold = gp._line(t_aff, t_aff, lam, p_g1)
    g00, g11, g12 = gold[0][0], gold[1][1], gold[1][2]
    # factor = 2 Y Z^2 = 2 y s^3 for t = (x s, y s, s)
    s = t[2]
    factor = gf.fp2_mul_fp(gf.fp2_mul(y1, gf.fp2_mul(s, gf.fp2_sqr(s))), 2)
    assert got[0] == gf.fp2_mul(g00, factor)
    assert got[1] == gf.fp2_mul(g11, factor)
    assert got[2] == gf.fp2_mul(g12, factor)


def _g1_mont(p):
    from kzg_rust_tpu.ops import limbs as L
    from kzg_rust_tpu.ops.fields import FP

    import jax.numpy as jnp

    rr = FP.mont_r
    xp = np.broadcast_to(
        L.int_to_limbs(FP.nlimbs, (p[0] * rr) % gf.P), (2, FP.nlimbs)
    )
    yp = np.broadcast_to(
        L.int_to_limbs(FP.nlimbs, (p[1] * rr) % gf.P), (2, FP.nlimbs)
    )
    return jnp.asarray(xp), jnp.asarray(yp)


@pytest.mark.slow
def test_miller_step_matches_golden_replica():
    """One full Miller iteration (square + tangent line + double, then
    chord line + mixed add) vs the identical algebra computed in golden
    bigints — an exact differential over the limb/tower kernels.

    slow: its cold XLA-CPU compile outlasts the whole tier-1 run (still
    compiling after 1300 s beside five busy workers).  The eager twin
    below keeps the same algebra in the default selection."""
    p_g1 = gc.g1_mul(gc.G1_GENERATOR, 11)
    f = rand_fp12()
    t, _t_aff = _rand_proj_g2(5)
    q = gc.g2_mul(gc.G2_GENERATOR, 3)
    xp_m, yp_m = _g1_mont(p_g1)
    qd = (T2.fp2_from_golden(q[0], (2,)), T2.fp2_from_golden(q[1], (2,)))

    f_dbl, t_dbl, f_add, t_add = dp.miller_step_kernel(
        T2.fp12_from_golden(f, (2,)), _to_dev_g2(t), qd, xp_m, yp_m
    )

    # Golden replica of the same formulas.
    def g_tangent(t):
        x, y, z = t
        xx = gf.fp2_sqr(x)
        two_yz2 = gf.fp2_mul_fp(gf.fp2_mul(gf.fp2_mul(y, z), z), 2)
        three_xx = gf.fp2_mul_fp(xx, 3)
        c00 = gf.fp2_mul_fp(gf.fp2_mul(two_yz2, gf.XI), p_g1[1])
        c11 = gf.fp2_sub(
            gf.fp2_mul(three_xx, x),
            gf.fp2_mul_fp(gf.fp2_mul(gf.fp2_sqr(y), z), 2),
        )
        c12 = gf.fp2_neg(gf.fp2_mul_fp(gf.fp2_mul(three_xx, z), p_g1[0]))
        return c00, c11, c12

    def g_chord(t):
        x, y, z = t
        nn = gf.fp2_sub(gf.fp2_mul(q[1], z), y)
        dd = gf.fp2_sub(gf.fp2_mul(q[0], z), x)
        a00 = gf.fp2_mul_fp(gf.fp2_mul(dd, gf.XI), p_g1[1])
        a11 = gf.fp2_sub(gf.fp2_mul(nn, q[0]), gf.fp2_mul(q[1], dd))
        a12 = gf.fp2_neg(gf.fp2_mul_fp(nn, p_g1[0]))
        return a00, a11, a12

    b3 = (12, 12)

    def g_double(t):
        x, y, z = t
        t0 = gf.fp2_sqr(y)
        z3 = gf.fp2_mul_fp(t0, 8)
        t1 = gf.fp2_mul(y, z)
        t2 = gf.fp2_mul(b3, gf.fp2_sqr(z))
        x3 = gf.fp2_mul(t2, z3)
        y3 = gf.fp2_add(t0, t2)
        z3 = gf.fp2_mul(t1, z3)
        t1 = gf.fp2_mul_fp(t2, 2)
        t2 = gf.fp2_add(t1, t2)
        t0 = gf.fp2_sub(t0, t2)
        y3 = gf.fp2_add(x3, gf.fp2_mul(t0, y3))
        x3 = gf.fp2_mul_fp(gf.fp2_mul(t0, gf.fp2_mul(x, y)), 2)
        return (x3, y3, z3)

    def g_madd(t):
        x1, y1, z1 = t
        x2, y2 = q
        t0 = gf.fp2_mul(x1, x2)
        t1 = gf.fp2_mul(y1, y2)
        t3 = gf.fp2_sub(
            gf.fp2_mul(gf.fp2_add(x1, y1), gf.fp2_add(x2, y2)),
            gf.fp2_add(t0, t1),
        )
        t4 = gf.fp2_add(gf.fp2_mul(y2, z1), y1)
        t5 = gf.fp2_add(gf.fp2_mul(x2, z1), x1)
        three_t0 = gf.fp2_mul_fp(t0, 3)
        bt2 = gf.fp2_mul(b3, z1)
        z3t = gf.fp2_add(t1, bt2)
        t1m = gf.fp2_sub(t1, bt2)
        y3t = gf.fp2_mul(b3, t5)
        x3 = gf.fp2_sub(gf.fp2_mul(t3, t1m), gf.fp2_mul(t4, y3t))
        y3 = gf.fp2_add(gf.fp2_mul(y3t, three_t0), gf.fp2_mul(t1m, z3t))
        z3 = gf.fp2_add(gf.fp2_mul(z3t, t4), gf.fp2_mul(three_t0, t3))
        return (x3, y3, z3)

    gf_dbl = gf.fp12_mul(gf.fp12_sqr(f), _sparse_line_fp12(*g_tangent(t)))
    gt_dbl = g_double(t)
    gf_add = gf.fp12_mul(gf_dbl, _sparse_line_fp12(*g_chord(gt_dbl)))
    gt_add = g_madd(gt_dbl)

    assert _fp12_to_golden_b(f_dbl) == gf_dbl
    assert tuple(_fp2_to_golden(c) for c in t_dbl) == gt_dbl
    assert _fp12_to_golden_b(f_add) == gf_add
    assert tuple(_fp2_to_golden(c) for c in t_add) == gt_add


def test_miller_step_matches_golden_replica_eager():
    """The same call and the same assertions as
    test_miller_step_matches_golden_replica, run EAGERLY (jax.disable_jit),
    as test_final_exp_composition_tiny_exponent does for the final
    exponentiation: eager dispatch runs the identical ops without the
    whole-step XLA-CPU compile, so the Miller-step algebra stays in the
    default selection."""
    import jax

    with jax.disable_jit():
        test_miller_step_matches_golden_replica()


def _rand_cyclotomic():
    """A random element of the cyclotomic subgroup (golden easy-part image)."""
    x = rand_fp12()
    m = gf.fp12_mul(gf.fp12_conj(x), gf.fp12_inv(x))
    return gf.fp12_mul(gf.fp12_frobenius_n(m, 2), m)


@pytest.mark.slow
def test_exp_by_x_kernel_matches_golden():
    if _on_cpu():
        pytest.skip(
            "XLA-CPU takes hours to compile the final-exp kernels (the 63-step "
            "cyclotomic scan / fp12-inverse graphs; measured >100 min); their "
            "constituent ops are CPU-verified in test_fp12_ops_match_golden and "
            "the compiled kernels run vs golden on TPU"
        )
    m = _rand_cyclotomic()
    got = dp._exp_by_x_kernel(T2.fp12_from_golden(m, (2,)))
    assert _fp12_to_golden_b(got) == gp._exp_by_x(m)


@pytest.mark.slow
def test_easy_part_kernel_matches_golden():
    if _on_cpu():
        pytest.skip(
            "XLA-CPU takes hours to compile the final-exp kernels (the 63-step "
            "cyclotomic scan / fp12-inverse graphs; measured >100 min); their "
            "constituent ops are CPU-verified in test_fp12_ops_match_golden and "
            "the compiled kernels run vs golden on TPU"
        )
    import jax.numpy as jnp

    f0, f1 = rand_fp12(), rand_fp12()
    d0 = T2.fp12_from_golden(f0)
    d1 = T2.fp12_from_golden(f1)
    stacked = dp._tmap(lambda a, b: jnp.stack([a, b], axis=0), d0, d1)
    got = dp._easy_part_kernel(stacked)
    x = gf.fp12_mul(f0, f1)
    m = gf.fp12_mul(gf.fp12_conj(x), gf.fp12_inv(x))
    want = gf.fp12_mul(gf.fp12_frobenius_n(m, 2), m)
    assert T2.fp12_to_golden(got) == want


@pytest.mark.slow
def test_hard_part_combines_match_golden():
    if _on_cpu():
        pytest.skip(
            "XLA-CPU takes hours to compile the final-exp kernels (the 63-step "
            "cyclotomic scan / fp12-inverse graphs; measured >100 min); their "
            "constituent ops are CPU-verified in test_fp12_ops_match_golden and "
            "the compiled kernels run vs golden on TPU"
        )
    m = _rand_cyclotomic()
    dm = T2.fp12_from_golden(m, (2,))
    # the three small combine kernels
    u_g = gf.fp12_mul(gp._exp_by_x(m), gf.fp12_conj(m))
    got_u = dp._mul_conj_kernel(dp._exp_by_x_kernel(dm), dm)
    assert _fp12_to_golden_b(got_u) == u_g
    w_g = gf.fp12_mul(gp._exp_by_x(u_g), gf.fp12_frobenius(u_g))
    got_w = dp._mul_frob_kernel(
        dp._exp_by_x_kernel(T2.fp12_from_golden(u_g, (2,))),
        T2.fp12_from_golden(u_g, (2,)),
    )
    assert _fp12_to_golden_b(got_w) == w_g
    # the tail: y = e5 * frob^2(w1) * conj(w1); out = y * m^3; is_one
    e5_g = gp._exp_by_x(gp._exp_by_x(w_g))
    y_g = gf.fp12_mul(
        gf.fp12_mul(e5_g, gf.fp12_frobenius_n(w_g, 2)), gf.fp12_conj(w_g)
    )
    out_g = gf.fp12_mul(y_g, gf.fp12_mul(gf.fp12_cyclo_sqr(m), m))
    got_tail = dp._hard_tail_kernel(
        T2.fp12_from_golden(e5_g, (2,)),
        T2.fp12_from_golden(w_g, (2,)),
        dm,
    )
    assert np.asarray(got_tail).all() == gf.fp12_is_one(out_g)
    # and the True branch: the identity flows through to is_one == True
    one = gf.FP12_ONE
    got_one = dp._hard_tail_kernel(
        T2.fp12_from_golden(one, (2,)),
        T2.fp12_from_golden(one, (2,)),
        T2.fp12_from_golden(one, (2,)),
    )
    assert bool(np.asarray(got_one).all()) is True


@pytest.mark.slow
def test_device_pairing_matches_golden():
    if _on_cpu():
        pytest.skip("CPU XLA takes >45min to compile the Miller scan; run on TPU")
    a = rng.randrange(1, gc.R)
    b = rng.randrange(1, gc.R)
    aP = gc.g1_mul(gc.G1_GENERATOR, a)
    bQ = gc.g2_mul(gc.G2_GENERATOR, b)
    abP = gc.g1_mul(gc.G1_GENERATOR, (a * b) % gc.R)
    # e(abP, Q) == e(aP, bQ)  (bilinearity)
    assert dp.pairings_verify_device(abP, gc.G2_GENERATOR, aP, bQ) is True
    # and a wrong pair fails
    assert dp.pairings_verify_device(aP, gc.G2_GENERATOR, aP, bQ) is False


@pytest.mark.slow
def test_device_pairing_infinity_semantics():
    if _on_cpu():
        pytest.skip("CPU XLA takes >45min to compile the Miller scan; run on TPU")
    a = rng.randrange(1, gc.R)
    aP = gc.g1_mul(gc.G1_GENERATOR, a)
    # both Miller loops degenerate -> product is 1 -> verifies (matches
    # golden/blst behavior on infinity inputs)
    assert dp.pairings_verify_device(None, gc.G2_GENERATOR, None, gc.G2_GENERATOR) is True
    got = dp.pairings_verify_device(aP, gc.G2_GENERATOR, None, gc.G2_GENERATOR)
    want = gp.pairings_verify(aP, gc.G2_GENERATOR, None, gc.G2_GENERATOR)
    assert got is want


@pytest.mark.slow
def test_final_exp_composition_tiny_exponent():
    """The EXACT production final-exponentiation composition — the
    ``_final_exp_hard_chain`` x-chain (five exp-by-x dispatches, the
    conj/frobenius combines) plus ``_hard_tail_expr`` — run with a tiny
    substitute exponent and checked against ONE independent golden
    exponentiation (VERDICT round-3 item 5: the off-TPU gate for
    composition regressions — chain order, dropped conjugates, Frobenius
    placement all change the effective exponent polynomial and fail here).

    With |x'| = 6 (bits (1, 0) below the MSB — both select branches
    exercised), the chain computes m^H for
    H = (x'-1)^2 (x'+p) (x'^2+p^2-1) + 3 at x' = -6 (negative like the real
    BLS parameter; exp-by-x conjugates at the end).  Runs EAGERLY
    (jax.disable_jit): XLA-CPU compile of even a 2-step fp12 scan body is
    >10 min (measured round 4), while eager evaluation of the same ops is
    ~2 min alone and exercises identical code.  slow: ~4 min beside the
    other workers of a cold run; tests/test_torch_pairing.py's test of the
    same name holds the port's composition to the same exponent.
    """
    import jax

    m = _rand_cyclotomic()
    dm = T2.fp12_from_golden(m)
    bits = (1, 0)  # |x'| = 0b110 = 6
    with jax.disable_jit():
        e5, w1 = dp._final_exp_hard_chain(
            dm, lambda v: dp._exp_by_x_with_bits(v, bits)
        )
        out = dp._hard_tail_value_kernel(e5, w1, dm)
        got = T2.fp12_to_golden(out)
    xs = -6
    H = (xs - 1) ** 2 * (xs + gf.P) * (xs**2 + gf.P**2 - 1) + 3
    assert got == gf.fp12_pow(m, H)
