"""The port's GLV fixed-base MSM (kzg_rust_tpu_torch.ops.msm and the mixed
add of ops.curve; the plain versions of M1, M2 and the mixed add on the
CPU) against the JAX package's ops.msm and ops.curve and the golden
lincomb, exactly.

Fp shares the radix 2^384 across the two packages, so tables and points
compare as raw words.  The JAX shapes are those tests/test_ops_msm.py
compiles (24 scalars, a 16-point table), so the persistent compile cache
usually holds them.
"""

from __future__ import annotations

import ctypes
import random
import re
from gc import collect as collect_garbage

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kzg_rust_tpu.ops import curve as JC
from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import msm as JM
from kzg_rust_tpu.ops.fields import FR as JFR
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P, R
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import curve as C
from kzg_rust_tpu_torch.ops import glv
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import msm as M
from kzg_rust_tpu_torch.utils.testing import glv_ripple_scalars

rng = random.Random(0x6D5A)
RR = L.FP.mont_r
# tests/test_ops_msm.py:21
EDGE_SCALARS = [0, 1, R - 1, R // 2, (R + 1) // 2, glv.Z2, R - glv.Z2, glv.LAM]


@pytest.fixture(autouse=True, scope="module")
def _worker_resources():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores.  At
    the end the module's compiled JAX programs are dropped and the freed
    heap goes back to the OS: the suite's workers share one machine's
    memory, and a worker keeps what it holds into its next file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    collect_garbage()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


@pytest.fixture(scope="module")
def points():
    """16 setup-like points, the last one infinity."""
    return [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(15)] + [None]


@pytest.fixture(scope="module")
def contexts(points):
    """The JAX package's table (fold 64, as tests/test_ops_msm.py builds it)
    and the port's, each built once."""
    return JM.MsmContext.build_from_points(points, fold=64), M.MsmContext.build_from_points(points, "cpu")


def _value(digits, i):
    return sum(int(digits[j, i]) * 32**j for j in range(M.GLV_NUM_WINDOWS))


def _recode32_lookahead(mag: int) -> list[int]:
    """M1's recoding of a magnitude as csrc/msm_kernels.cu
    glv_digits_lanes_kernel resolves its carries: a window generates a
    carry when its raw value is 17 or more and passes one on when it is 16,
    and bit j of (gen + prop) ^ gen ^ prop, prop = raw >= 16, is window j's
    carry in."""
    raw = [(mag >> (5 * j)) & 31 for j in range(M.GLV_NUM_WINDOWS)]
    gen = sum(1 << j for j, w in enumerate(raw) if w >= 17)
    prop = sum(1 << j for j, w in enumerate(raw) if w >= 16)
    carries = (gen + prop) ^ gen ^ prop
    return [w + (carries >> j & 1) - 32 * (carries >> (j + 1) & 1) for j, w in enumerate(raw)]


@pytest.mark.parametrize("case", ["random", "ripple"])
def test_glv_digits_match_jax(case):
    """M1's plain version (serial carries) against the JAX device split,
    digit for digit, and against the kernel's carry lookahead (mirrored
    here) on the same halves; the halves recombine to k and stay below
    2^128.  Both cases end with the edge scalars (0, 1, r - 1,
    ceil(r / 2) - 1, ceil(r / 2) among them); the ripple case holds runs of
    16-valued windows with a carry in (utils.testing.glv_ripple_scalars),
    so that the lookahead crosses many windows.  24 scalars in both, the
    shape the JAX program is already compiled for."""
    scalars = ([rng.randrange(R) for _ in range(16)] if case == "random" else glv_ripple_scalars()) + EDGE_SCALARS
    assert len(scalars) == 24
    jd1, jd2 = JM.glv_digits_from_limbs(jnp.asarray(JL.ints_to_limbs(JFR.nlimbs, scalars)))
    got = M.glv_digits_from_limbs(L.to_device(L.FR, scalars, "cpu"))
    assert got.dtype == torch.int8 and got.shape == (2, 26, len(scalars))
    assert (got[0].numpy() == np.asarray(jd1)).all()
    assert (got[1].numpy() == np.asarray(jd2)).all()
    assert got.abs().max() <= 16
    for i, k in enumerate(scalars):
        v1, v2 = _value(got[0], i), _value(got[1], i)
        assert (v1 + v2 * glv.LAM) % R == k
        assert abs(v1) < 2**128 and abs(v2) < 2**128
        for half, v in ((0, v1), (1, v2)):
            sign = -1 if v < 0 else 1
            assert got[half, :, i].tolist() == [sign * d for d in _recode32_lookahead(abs(v))], (i, half)
    if case == "ripple":
        # k1 of the first ripple scalar, k2 of its m1 twin: 17, then 24
        # windows of 16 that each take the carry (16 + 1 - 32) and the
        # carry out of the run.
        k1, k2 = got[0, :, 0], got[1, :, 5]
        assert k1[:26].tolist() == [-15] * 25 + [1]
        assert k2[:26].tolist() == [15] * 25 + [-1]
    with pytest.raises(ValueError, match="lanes"):
        M.glv_digits_from_limbs(L.to_device(L.FR, scalars, "cpu"), lanes=2)


def test_recode_glv_host_matches_jax():
    scalars = [rng.randrange(R) for _ in range(6)] + EDGE_SCALARS
    for got, want in zip(M.recode_glv_host(scalars), JM.recode_glv_host(scalars)):
        assert (got == want).all()


def _proj_rows(pts, seed):
    """Golden points -> projective Montgomery int rows with a random factor."""
    r = np.random.default_rng(seed)
    rows = []
    for p in pts:
        lam = (int.from_bytes(r.bytes(56), "little") % (P - 1) + 1) * RR % P
        rows += [0, lam, 0] if p is None else [p[0] * lam % P, p[1] * lam % P, lam]
    return rows


def test_proj_add_mixed_matches_jax():
    """The mixed add's plain version against the JAX package's, word for
    word, with an infinity accumulator, P + P and P + (-P) among the lanes."""
    base = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(5)]
    neg = (base[1][0], (-base[1][1]) % P)
    ps = [base[0], base[1], None, base[2], None, base[3], base[4], base[0]]
    qs = [base[0], neg, base[2], base[3], base[4], base[1], base[0], base[2]]
    prow = _proj_rows(ps, 11)
    qrow = [v * RR % P for q in qs for v in q]
    p = L.to_device(L.FP, prow, "cpu").reshape(8, 3, 12)
    q = L.to_device(L.FP, qrow, "cpu").reshape(8, 2, 12)
    jp = jnp.asarray(JL.ints_to_limbs(32, prow).reshape(8, 3, 32))
    jq = jnp.asarray(JL.ints_to_limbs(32, qrow).reshape(8, 2, 32))
    want = np.asarray(JC.proj_add_mixed(jp, jq))
    got = C.proj_add_mixed(p, q)
    assert torch.equal(got, JS.points_from_jax(want))
    assert C.proj_to_points(got) == [gc.g1_add(a, b) for a, b in zip(ps, qs)]
    inf = C.point_is_inf(got)
    assert inf.tolist() == list(np.asarray(JC.point_is_inf(jnp.asarray(want))))
    assert inf.tolist() == [False, True] + [False] * 6


def test_table_matches_jax(contexts, points):
    """The port's table build (K4 chain, K3 multiples, batched inversion)
    equals the JAX package's word for word, infinity column included, and
    its entries are d 32^j P."""
    jctx, ctx = contexts
    assert ctx.table.shape == (26, 16, 16, 2, 12) and ctx.n == 16
    assert torch.equal(ctx.table, JS.fp_from_jax(np.asarray(jctx.table)))
    assert ctx.inf_mask.tolist() == list(np.asarray(jctx.inf_mask)) == [False] * 15 + [True]
    rinv = pow(RR, -1, P)
    for j, d, i in ((0, 0, 0), (3, 15, 7), (25, 9, 14)):
        x, y = (v * rinv % P for v in L.words_to_ints(ctx.table[j, d, i]))
        assert (x, y) == gc.g1_mul(points[i], (d + 1) * 32**j)


def _scalar_cases():
    return {
        "random": [rng.randrange(R) for _ in range(16)],
        "zero": [0] * 16,
        "one_hot": [0] * 3 + [1] + [0] * 12,
        "all_r_minus_1": [R - 1] * 16,
    }


@pytest.mark.parametrize("case", ["random", "zero", "one_hot", "all_r_minus_1"])
def test_msm_fixed_base_on_jax_table(case, contexts, points):
    """The JAX table carried over (msm_context_from_jax) through the port's
    msm_fixed_base (host recoding, M2) equals the naive lincomb."""
    jctx, _ = contexts
    ctx = JS.msm_context_from_jax(np.asarray(jctx.table), np.asarray(jctx.inf_mask))
    assert (ctx.accumulators, ctx.block) == (M.CPU_ACCUMULATORS, M.CPU_BLOCK)
    scalars = _scalar_cases()[case]
    got = M.msm_fixed_base(ctx, scalars)
    assert got == gc.g1_lincomb_naive(points, scalars)
    if case == "zero":
        assert got is None
    if case == "one_hot":
        assert got == points[3]


@pytest.mark.parametrize("accumulators", [1, 7, 64, 100, 832])
def test_device_digits_msm(accumulators, contexts, points):
    """M1's digits through M2's plain version at several accumulator counts
    in blocks of CPU_BLOCK = 16: one accumulator, one ragged block (7),
    the default (four full blocks), a ragged last block (100), one
    selection an accumulator (52 blocks).  The point is the lincomb.  The
    single accumulator adds its selections one after another (~11 ms each
    here), so its scalars are below 2^32: ~100 selections instead of 832."""
    _, ctx = contexts
    if accumulators == 1:
        scalars = [rng.randrange(2**32) for _ in range(16)]
    else:
        scalars = [rng.randrange(R) for _ in range(15)] + [R - 1]
    digits = M.glv_digits_from_limbs(L.to_device(L.FR, scalars, "cpu"))
    point = M.msm_point(ctx.table, ctx.inf_mask, digits, accumulators, M.CPU_BLOCK)
    assert point.shape == (3, 12)
    assert C.proj_to_points(point[None])[0] == gc.g1_lincomb_naive(points, scalars)


def test_msm_point_matches_jax(contexts, points):
    """Given the same table and M1's digits, the port's M2 point equals the
    JAX package's _msm_core_glv (fold 64, as tests/test_ops_msm.py compiles
    it) as an affine point; the projective words differ with the order of
    the sums."""
    jctx, ctx = contexts
    scalars = [rng.randrange(R) for _ in range(16)]
    digits = M.glv_digits_from_limbs(L.to_device(L.FR, scalars, "cpu"))
    d1, d2 = (jnp.asarray(digits[h].numpy(), dtype=jnp.int32) for h in (0, 1))
    want = np.asarray(JM._msm_glv_kernel(jctx.table, jctx.inf_mask, d1, d2, jctx.fold))
    got = M.msm_point(ctx.table, ctx.inf_mask, digits, ctx.accumulators, ctx.block)
    assert C.proj_to_points(got[None]) == C.proj_to_points(JS.points_from_jax(want[None]))
    assert C.proj_to_points(got[None])[0] == gc.g1_lincomb_naive(points, scalars)


@pytest.fixture(scope="module")
def edge_context():
    """A 16-point table whose second half repeats and negates the first:
    points 8-11 are points 0-3, 12-14 are -(4-6), 7 and 15 infinity; the
    scalars repeat too, so selections s and s + 8 take the same entry or
    its negation."""
    base = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(7)] + [None]
    pts = base + base[:4] + [(p[0], (-p[1]) % P) for p in base[4:7]] + [None]
    ks = [rng.randrange(R) for _ in range(8)]
    return M.MsmContext.build_from_points(pts, "cpu"), pts, ks + ks


@pytest.mark.parametrize("accumulators", [8, 16])
def test_msm_equal_and_opposite_points(accumulators, edge_context):
    """Accumulator a takes selections a and a + 8 in turn at 8 accumulators,
    so its mixed adds meet P == Q (points 0-3), P == -Q (4-6, leaving
    infinity, which the next add starts from) and infinity bases (7, 15);
    at 16 (one block) accumulator i is k_i P_i and the tree's first level
    adds accumulators i and i + 8, so its complete adds meet the same
    cases.  The point is the lincomb either way."""
    ctx, pts, ks = edge_context
    digits = M.glv_digits_from_limbs(L.to_device(L.FR, ks, "cpu"))
    got = M.msm_point(ctx.table, ctx.inf_mask, digits, accumulators, M.CPU_BLOCK)
    assert C.proj_to_points(got[None])[0] == gc.g1_lincomb_naive(pts, ks)
    if accumulators == 8:
        # Window 0 of half 0 alone: accumulators 0-3 double their entry, 4-6
        # cancel to infinity, 7 meets only infinity bases and is never
        # started.
        first = torch.zeros_like(digits)
        first[0, 0] = digits[0, 0]
        acc = M.msm_accumulate_plain(ctx.table, ctx.inf_mask, first, 8)
        assert C.point_is_inf(acc).tolist() == [False] * 4 + [True] * 4
        doubled = [gc.g1_mul(p, 2 * int(first[0, 0, i]) % R) for i, p in enumerate(pts[:4])]
        assert C.proj_to_points(acc[:4]) == doubled
        # Then window 1 of points 0-7 alone: accumulators 4-6, at infinity
        # after P + (-P), add their next entry with the complete add.
        first[0, 1, :8] = digits[0, 1, :8]
        acc = M.msm_accumulate_plain(ctx.table, ctx.inf_mask, first, 8)
        assert C.proj_to_points(acc[4:7]) == [gc.g1_mul(pts[i], int(first[0, 1, i]) * 32 % R) for i in range(4, 7)]


def test_block_sums_follow_sum_points(contexts):
    """M2's plain block sums are sum_points over each block's rows, the
    ragged last block included, and the point is sum_points over them."""
    _, ctx = contexts
    digits = M.glv_digits_from_limbs(L.to_device(L.FR, [rng.randrange(R) for _ in range(16)], "cpu"))
    acc = M.msm_accumulate_plain(ctx.table, ctx.inf_mask, digits, 40)
    sums = M.block_sums_plain(acc, 16)
    assert sums.shape == (3, 3, 12)
    for b, rows in enumerate((acc[:16], acc[16:32], acc[32:])):
        assert torch.equal(sums[b], C.sum_points(rows))
    assert torch.equal(M.msm_point(ctx.table, ctx.inf_mask, digits, 40, 16), C.sum_points(sums))


def test_msm_operand_checks(contexts):
    _, ctx = contexts
    digits = torch.zeros((2, 26, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="digits"):
        M.msm_point(ctx.table, ctx.inf_mask, digits.to(torch.int32), 8, 16)
    with pytest.raises(ValueError, match="accumulators"):
        M.msm_point(ctx.table, ctx.inf_mask, digits, 0, 16)
    with pytest.raises(ValueError, match="blocks"):
        M.msm_point(ctx.table, ctx.inf_mask, digits, 832, 0)
    with pytest.raises(ValueError, match="mask"):
        M.msm_point(ctx.table, ctx.inf_mask[:8], digits, 8, 16)


def test_kernel_constants_match():
    """The immediates of csrc/msm_kernels.cu are the Python constants, and
    the block sizes its entry point dispatches and its most blocks are
    ops/msm.py's."""
    text = open(f"{_build.CSRC}/msm_kernels.cu").read()

    def words(name):
        body = re.search(name + r"_word\(int j\) \{\s*constexpr uint32_t w\[\d+\] = \{([^}]*)\}", text).group(1)
        return sum(int(w.strip().rstrip("u"), 16) << (32 * k) for k, w in enumerate(body.split(",")))

    assert words("g1c") == glv.G1C
    assert words("z2") == glv.Z2
    assert words("z2m1") == glv.Z2 - 1
    assert words("half_r") == glv.HALF_R_CEIL
    assert words("beta_mont") == C.BETA_MONT
    assert words("one_mont") == L.FP.mont_r
    cases = re.findall(r"case (\d+): return launch_msm<(\d+)>", text)
    assert all(case == block for case, block in cases)
    assert tuple(int(block) for _, block in cases) == M.KERNEL_BLOCKS
    assert M.BLOCK_THREADS in M.KERNEL_BLOCKS
    assert M.ACCUMULATORS_PER_SM % M.BLOCK_THREADS == 0
    assert int(re.search(r"constexpr int kMaxBlocks = (\d+);", text).group(1)) == M.MAX_BLOCKS
    assert _build.ENTRY_POINTS["kzg_msm_glv"][0] == "msm_kernels.cu"
    digit_cases = re.findall(r"case (\d+):\s*glv_digits(?:_lanes_kernel<(\d+)>|_kernel)<<<", text)
    assert [int(c) for c, _ in digit_cases] == sorted(M.GLV_DIGIT_LANES)
    assert all(not g or g == c for c, g in digit_cases)
    assert _build.ENTRY_POINTS["kzg_glv_digits"][0] == "msm_kernels.cu"
