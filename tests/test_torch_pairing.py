"""The port's device pairing (kzg_rust_tpu_torch.ops.pairing) against the
JAX package's ops/pairing.py and the golden model.

One Miller step at [2] against the JAX package's, eagerly (a compiled
pairing program takes minutes on XLA-CPU); the G2 steps, the line
coefficients and the sparse line product against the golden replica of
the same formulas (copied from tests/test_ops_pairing.py); the whole plain
Miller loop (kernel P2's plain version) against that replica run for all
63 steps in Python ints; the final exponentiation's composition with a
tiny exponent against one golden exponentiation, its easy part and P3's
plain version against golden; and the whole slice as one batched plain
``pairings_verify_kernel`` call at [2, 4] (a valid opening from
tests/vectors, a wrong y, P at infinity, Q at infinity) against the golden
pairing and the host engine's.  Also the kernels' constants in
``csrc/pairing_kernels.cu`` and the device entry point's refusal to run
without CUDA.  Comparisons are exact.
"""

from __future__ import annotations

import ctypes
import glob
import os
import pathlib
import random
import re
from gc import collect as collect_garbage

import jax
import numpy as np
import pytest
import torch
import yaml

from kzg_rust_tpu.ops import pairing as JP
from kzg_rust_tpu_torch import hostcrypto
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden import field as gf
from kzg_rust_tpu_torch.golden import pairing as gp
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import pairing as P
from kzg_rust_tpu_torch.ops import pairing_programs as PP
from kzg_rust_tpu_torch.ops import tower as T

from .conftest import REPO_ROOT, VECTOR_DIR

rng = random.Random(0xE11)


@pytest.fixture(autouse=True, scope="module")
def _worker_resources():
    """One intra-op thread per test worker; at the end the module's JAX
    programs are dropped and the freed heap goes back to the OS."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    collect_garbage()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


def rand_fp2():
    return (rng.randrange(gf.P), rng.randrange(gf.P))


def rand_fp12():
    return ((rand_fp2(), rand_fp2(), rand_fp2()), (rand_fp2(), rand_fp2(), rand_fp2()))


def _mont(v: int) -> int:
    return v * L.FP.mont_r % gf.P


def _fp(v: int, shape=(2,)):
    return L.to_device(L.FP, [_mont(v)], "cpu")[0].expand(tuple(shape) + (12,))


def _golden(x, lane: int = 0):
    """Lane ``lane`` of port tuples -> golden ints (canonical)."""
    if isinstance(x, tuple):
        return tuple(_golden(p, lane) for p in x)
    return L.words_to_ints(L.from_mont(L.FP, x.reshape(-1, 12)[lane : lane + 1]))[0]


def _sparse_line_fp12(c00, c11, c12):
    return ((c00, gf.FP2_ZERO, gf.FP2_ZERO), (gf.FP2_ZERO, c11, c12))


def _rand_proj_g2(k: int):
    """Projective G2 point [k]G2 with a random Z scale, golden ints."""
    x, y = gc.g2_mul(gc.G2_GENERATOR, k)
    s = rand_fp2()
    return (gf.fp2_mul(x, s), gf.fp2_mul(y, s), s), (x, y)


def _to_dev_g2(t):
    return tuple(T.fp2_from_golden(c, (2,)) for c in t)


# ---------------------------------------------------------------------------
# The golden replica of the device formulas (tests/test_ops_pairing.py:201-257)
# ---------------------------------------------------------------------------

B3 = (12, 12)


def g_tangent(t, p_g1):
    x, y, z = t
    xx = gf.fp2_sqr(x)
    two_yz2 = gf.fp2_mul_fp(gf.fp2_mul(gf.fp2_mul(y, z), z), 2)
    three_xx = gf.fp2_mul_fp(xx, 3)
    c00 = gf.fp2_mul_fp(gf.fp2_mul(two_yz2, gf.XI), p_g1[1])
    c11 = gf.fp2_sub(gf.fp2_mul(three_xx, x), gf.fp2_mul_fp(gf.fp2_mul(gf.fp2_sqr(y), z), 2))
    c12 = gf.fp2_neg(gf.fp2_mul_fp(gf.fp2_mul(three_xx, z), p_g1[0]))
    return c00, c11, c12


def g_chord(t, q, p_g1):
    x, y, z = t
    nn = gf.fp2_sub(gf.fp2_mul(q[1], z), y)
    dd = gf.fp2_sub(gf.fp2_mul(q[0], z), x)
    a00 = gf.fp2_mul_fp(gf.fp2_mul(dd, gf.XI), p_g1[1])
    a11 = gf.fp2_sub(gf.fp2_mul(nn, q[0]), gf.fp2_mul(q[1], dd))
    a12 = gf.fp2_neg(gf.fp2_mul_fp(nn, p_g1[0]))
    return a00, a11, a12


def g_double(t):
    x, y, z = t
    t0 = gf.fp2_sqr(y)
    z3 = gf.fp2_mul_fp(t0, 8)
    t1 = gf.fp2_mul(y, z)
    t2 = gf.fp2_mul(B3, gf.fp2_sqr(z))
    x3 = gf.fp2_mul(t2, z3)
    y3 = gf.fp2_add(t0, t2)
    z3 = gf.fp2_mul(t1, z3)
    t1 = gf.fp2_mul_fp(t2, 2)
    t2 = gf.fp2_add(t1, t2)
    t0 = gf.fp2_sub(t0, t2)
    y3 = gf.fp2_add(x3, gf.fp2_mul(t0, y3))
    x3 = gf.fp2_mul_fp(gf.fp2_mul(t0, gf.fp2_mul(x, y)), 2)
    return (x3, y3, z3)


def g_madd(t, q):
    x1, y1, z1 = t
    x2, y2 = q
    t0 = gf.fp2_mul(x1, x2)
    t1 = gf.fp2_mul(y1, y2)
    t3 = gf.fp2_sub(gf.fp2_mul(gf.fp2_add(x1, y1), gf.fp2_add(x2, y2)), gf.fp2_add(t0, t1))
    t4 = gf.fp2_add(gf.fp2_mul(y2, z1), y1)
    t5 = gf.fp2_add(gf.fp2_mul(x2, z1), x1)
    three_t0 = gf.fp2_mul_fp(t0, 3)
    bt2 = gf.fp2_mul(B3, z1)
    z3t = gf.fp2_add(t1, bt2)
    t1m = gf.fp2_sub(t1, bt2)
    y3t = gf.fp2_mul(B3, t5)
    x3 = gf.fp2_sub(gf.fp2_mul(t3, t1m), gf.fp2_mul(t4, y3t))
    y3 = gf.fp2_add(gf.fp2_mul(y3t, three_t0), gf.fp2_mul(t1m, z3t))
    z3 = gf.fp2_add(gf.fp2_mul(z3t, t4), gf.fp2_mul(three_t0, t3))
    return (x3, y3, z3)


def g_miller(p_g1, q):
    """The device Miller loop in golden ints: 63 steps over the bits of
    |x|, the same line scales, conjugated at the end."""
    f, t = gf.FP12_ONE, (q[0], q[1], gf.FP2_ONE)
    for bit in P._X_BITS:
        f = gf.fp12_mul(gf.fp12_sqr(f), _sparse_line_fp12(*g_tangent(t, p_g1)))
        t = g_double(t)
        if bit:
            f = gf.fp12_mul(f, _sparse_line_fp12(*g_chord(t, q, p_g1)))
            t = g_madd(t, q)
    return gf.fp12_conj(f)


# ---------------------------------------------------------------------------
# Against the JAX package and the golden replica
# ---------------------------------------------------------------------------


def test_miller_step_matches_jax_and_golden():
    """One full Miller iteration at [2] (square, tangent line, doubling,
    then chord line and mixed add) equals the JAX package's miller_step,
    eagerly, word for word, and the golden replica of the same formulas."""
    p_g1 = gc.g1_mul(gc.G1_GENERATOR, 11)
    f = rand_fp12()
    t, _ = _rand_proj_g2(5)
    q = gc.g2_mul(gc.G2_GENERATOR, 3)
    jf, jt = JP.T2.fp12_from_golden(f, (2,)), tuple(JP.T2.fp2_from_golden(c, (2,)) for c in t)
    jq = (JP.T2.fp2_from_golden(q[0], (2,)), JP.T2.fp2_from_golden(q[1], (2,)))
    jxp, jyp = (JP.T2.fp2_from_golden((v, 0), (2,))[0] for v in p_g1)
    with jax.disable_jit():
        want = jax.tree_util.tree_map(np.asarray, JP.miller_step(jf, jt, jq, jxp, jyp))
    got = P.miller_step(T.fp12_from_golden(f, (2,)), _to_dev_g2(t), (T.fp2_from_golden(q[0], (2,)), T.fp2_from_golden(q[1], (2,))), _fp(p_g1[0]), _fp(p_g1[1]))
    for g, w, convert in zip(got, want, (JS.fp12_from_jax, JS.fp6_from_jax, JS.fp12_from_jax, JS.fp6_from_jax)):
        assert torch.equal(T.pack(g), T.pack(convert(w)))
    gf_dbl = gf.fp12_mul(gf.fp12_sqr(f), _sparse_line_fp12(*g_tangent(t, p_g1)))
    gt_dbl = g_double(t)
    assert _golden(got[0]) == gf_dbl and _golden(got[1]) == gt_dbl
    assert _golden(got[2]) == gf.fp12_mul(gf_dbl, _sparse_line_fp12(*g_chord(gt_dbl, q, p_g1)))
    assert _golden(got[3]) == g_madd(gt_dbl, q)


def test_g2_steps_lines_and_sparse_products_match_golden():
    """The RCB doubling and mixed add equal golden affine arithmetic after
    normalisation and the replica word for word; the tangent line is the
    golden affine line times 2YZ^2; the chord line, fp12_mul_by_line and
    the sparse Fp6 product equal the replica and golden products."""
    t, t_aff = _rand_proj_g2(5)
    q = gc.g2_mul(gc.G2_GENERATOR, 9)
    p_g1 = gc.g1_mul(gc.G1_GENERATOR, 7)
    dt, dq = _to_dev_g2(t), (T.fp2_from_golden(q[0], (2,)), T.fp2_from_golden(q[1], (2,)))
    dbl, madd = _golden(P._g2_double(dt)), _golden(P._g2_madd(dt, dq))
    assert dbl == g_double(t) and madd == g_madd(t, q)

    def norm(v):
        zi = gf.fp2_inv(v[2])
        return (gf.fp2_mul(v[0], zi), gf.fp2_mul(v[1], zi))

    assert norm(dbl) == gc.g2_add(t_aff, t_aff) and norm(madd) == gc.g2_add(t_aff, q)
    tangent = _golden(P.tangent_line_coeffs(dt, _fp(p_g1[0]), _fp(p_g1[1])))
    assert tangent == g_tangent(t, p_g1)
    x1, y1 = t_aff
    lam = gf.fp2_mul(gf.fp2_mul_fp(gf.fp2_sqr(x1), 3), gf.fp2_inv(gf.fp2_mul_fp(y1, 2)))
    gold = gp._line(t_aff, t_aff, lam, p_g1)
    factor = gf.fp2_mul_fp(gf.fp2_mul(y1, gf.fp2_mul(t[2], gf.fp2_sqr(t[2]))), 2)  # 2 Y Z^2
    assert tangent == tuple(gf.fp2_mul(g, factor) for g in (gold[0][0], gold[1][1], gold[1][2]))
    assert _golden(P.chord_line_coeffs(dt, dq, _fp(p_g1[0]), _fp(p_g1[1]))) == g_chord(t, q, p_g1)
    f, c = rand_fp12(), (rand_fp2(), rand_fp2(), rand_fp2())
    got = P.fp12_mul_by_line(T.fp12_from_golden(f, (2,)), *(T.fp2_from_golden(x, (2,)) for x in c))
    assert _golden(got) == gf.fp12_mul(f, _sparse_line_fp12(*c))
    a6 = f[0]
    got6 = P._fp6_mul_sparse01(tuple(T.fp2_from_golden(x) for x in a6), T.fp2_from_golden(c[1]), T.fp2_from_golden(c[2]))
    assert _golden(got6) == gf.fp6_mul(a6, (gf.FP2_ZERO, c[1], c[2]))


def test_miller_loop_matches_golden_replica():
    """The whole plain Miller loop (P2's plain version) over [2, 2] lanes:
    every active lane equals the replica run for all 63 steps in Python
    ints, word for word; an inactive lane (an infinity argument) is one."""
    pts = [(gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, gc.R)), gc.g2_mul(gc.G2_GENERATOR, rng.randrange(1, gc.R))) for _ in range(3)]
    checks = [(gc.g1_neg(pts[0][0]), pts[0][1], pts[1][0], pts[1][1]), (pts[2][0], None, pts[2][0], pts[2][1])]
    xp, yp, qx, qy, active = P.pairing_inputs(checks, "cpu")
    assert active.tolist() == [[True, False], [True, True]]
    f = P.miller_loop_kernel(xp, yp, qx, qy, active)
    want = [[g_miller(pts[0][0], pts[0][1]), gf.FP12_ONE], [g_miller(pts[1][0], pts[1][1]), g_miller(pts[2][0], pts[2][1])]]
    packed = T.pack(f)
    for i in range(2):
        for j in range(2):
            assert T.fp12_to_golden(packed[i, j]) == want[i][j], (i, j)
    # The loop's value is the golden Miller value times Fp2 factors that the
    # final exponentiation annihilates.
    assert gp.final_exponentiation(want[1][1]) == gp.final_exponentiation(gp.miller_loop(pts[2][0], pts[2][1]))


def _rand_cyclotomic():
    x = rand_fp12()
    m = gf.fp12_mul(gf.fp12_conj(x), gf.fp12_inv(x))
    return gf.fp12_mul(gf.fp12_frobenius_n(m, 2), m)


def test_final_exp_composition_tiny_exponent():
    """The final exponentiation's composition (``_final_exp_hard_chain``'s
    five exponentiations, conjugations and Frobenius, then
    ``_hard_tail_expr``) with |x'| = 6 (bits (1, 0): both branches) is
    m^H, H = (x'-1)^2 (x'+p)(x'^2+p^2-1) + 3 at x' = -6, against one golden
    exponentiation; P3's plain version, with its easy part in front,
    gives the same for (f, 1); the easy part equals golden's."""
    bits = (1, 0)
    xs = -6
    h = (xs - 1) ** 2 * (xs + gf.P) * (xs**2 + gf.P**2 - 1) + 3
    m = _rand_cyclotomic()
    dm = T.fp12_from_golden(m)
    e5, w1 = P._final_exp_hard_chain(dm, lambda v: P._exp_by_x_with_bits(v, bits))
    assert T.fp12_to_golden(P._hard_tail_value_kernel(e5, w1, dm)) == gf.fp12_pow(m, h)
    f0, f1 = rand_fp12(), rand_fp12()
    stacked = torch.stack([T.pack(T.fp12_from_golden(f0)), T.pack(T.fp12_from_golden(f1))])  # [2, 2, 3, 2, 12]
    x = gf.fp12_mul(f0, f1)
    em = gf.fp12_mul(gf.fp12_conj(x), gf.fp12_inv(x))
    em = gf.fp12_mul(gf.fp12_frobenius_n(em, 2), em)
    assert T.fp12_to_golden(T.pack(P._easy_part_kernel(T.unpack(stacked, 3)))) == em
    one = T.pack(T.fp12_from_golden(gf.FP12_ONE))
    got = P.final_exp(torch.stack([stacked[0], one]).unsqueeze(1), bits, value=True)
    assert got.shape == (1, 2, 3, 2, 12)
    x0 = f0
    em0 = gf.fp12_mul(gf.fp12_conj(x0), gf.fp12_inv(x0))
    em0 = gf.fp12_mul(gf.fp12_frobenius_n(em0, 2), em0)
    assert T.fp12_to_golden(got[0]) == gf.fp12_pow(em0, h)


def _opening():
    """A valid verify_kzg_proof vector with finite points, and [s]G2 of
    the committed setup: (commitment, z, y, proof, s_g2)."""
    for path in sorted(glob.glob(os.path.join(VECTOR_DIR, "verify_kzg_proof", "*", "*correct_proof*", "data.yaml"))):
        with open(path) as fh:
            case = yaml.safe_load(fh)
        inp = case["input"]
        c, pr = (gc.g1_uncompress(bytes.fromhex(inp[k][2:])) for k in ("commitment", "proof"))
        if case["output"] is True and c is not None and pr is not None:
            z, y = (int(inp[k], 16) for k in ("z", "y"))
            break
    with open(os.path.join(REPO_ROOT, "data", "trusted_setup.txt")) as fh:
        n1, _ = int(fh.readline()), int(fh.readline())
        for _ in range(n1 + 1):
            fh.readline()
        s_g2 = gc.g2_uncompress(bytes.fromhex(fh.readline().strip()))
    return c, z, y, pr, s_g2


def test_pairings_verify_kernel_batch():
    """The whole slice: one batched plain ``pairings_verify_kernel`` call
    over [2, 4] lanes, the checks of verify_kzg_proof (e(C - [y]G1, G2) ==
    e(proof, [s - z]G2)) for a valid opening, a wrong y, P at infinity and
    Q at infinity, equals the golden pairing and the host engine's."""
    c, z, y, pr, s_g2 = _opening()
    q = gc.g2_add(s_g2, gc.g2_neg(gc.g2_mul(gc.G2_GENERATOR, z)))

    def check(yy):
        return (gc.g1_add(c, gc.g1_neg(gc.g1_mul(gc.G1_GENERATOR, yy))), gc.G2_GENERATOR, pr, q)

    checks = [check(y), check(y + 1), (None, gc.G2_GENERATOR, pr, q), (c, None, c, gc.G2_GENERATOR)]
    got = P.pairings_verify_kernel(*P.pairing_inputs(checks, "cpu"))
    assert got.dtype == torch.bool and got.shape == (4,)
    want = [gp.pairings_verify(*ch) for ch in checks]
    assert got.tolist() == want == [hostcrypto.pairings_verify(*ch) for ch in checks]
    assert want[:2] == [True, False]


def test_pairings_verify_device_needs_cuda(monkeypatch):
    """The device entry point runs on the card unless asked for the CPU:
    without CUDA it raises, and it never runs on the CPU quietly; the
    wrappers refuse what the kernels do not take."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.pairings_verify_device(None, gc.G2_GENERATOR, None, gc.G2_GENERATOR)
    assert P.pairings_verify_device_batch([], device="cpu") == []
    f = torch.zeros((2, 1, 2, 3, 2, 12), dtype=torch.int32)
    for bad in (
        lambda: P.final_exp(f[0]),
        lambda: P.final_exp(f, bits=(2,)),
        lambda: P.final_exp(f, bits=(1,) * 65),
        lambda: P.miller_loop(f[..., 0, 0, 0, :], f[..., 0, 0, 0, :], f[..., 0, :2, :, :], torch.ones((3, 1), dtype=torch.bool)),
    ):
        with pytest.raises(ValueError):
            bad()


def test_pairing_source_constants_match_golden():
    """csrc/pairing_kernels.cu's constants: |x| (the Miller loop's bits)
    and its 64 bits; the room of its P3 sequence for the longest one the
    entry point takes (64 set bits); b3 = 12 + 12u is the programs' (12 xi
    by additions, held to the replica's b3 by test_p2_programs_match_replica)."""
    text = (pathlib.Path(_build.CSRC) / "pairing_kernels.cu").read_text()
    assert int(re.search(r"kAbsX = (0x[0-9a-f]+)ull;", text).group(1), 16) == gf.BLS_X
    bits = int(re.search(r"kAbsXBits = (\d+);", text).group(1))
    assert bits == gf.BLS_X.bit_length()
    room = re.search(r"kMaxSeq = 1 \+ 5 \* \(2 \* kAbsXBits \+ 2\) \+ 3;", text)
    assert room and 1 + 5 * (2 * bits + 2) + 3 >= len(PP.p3_sequence((1,) * bits))
    assert P._ABS_X_BITS == tuple((gf.BLS_X >> i) & 1 for i in range(62, -1, -1)) == PP.X_BITS
    for entry in ("kzg_fp12_op", "kzg_miller_loop", "kzg_final_exp"):
        assert _build.ENTRY_POINTS[entry][0] == "pairing_kernels.cu"


# ---------------------------------------------------------------------------
# The kernels' programs (ops/pairing_programs.py) with Python ints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def programs():
    return PP.build()


def _frame(programs, kernel, regs: dict) -> list[int]:
    frame = PP.new_frame(kernel, programs)
    for name, value in regs.items():
        first, _ = programs[kernel]["registers"][name]
        flat = PP.flatten(value)
        frame[first : first + len(flat)] = flat
    return frame


def _run(programs, kernel, names, frame) -> list[int]:
    for name in names:
        PP.execute(programs[kernel]["programs"][name], frame)
    return frame


def _reg(programs, kernel, frame, name):
    first, n = programs[kernel]["registers"][name]
    return PP.nest(frame[first : first + n], PP._shape(n))


def _fp_words(words):
    return [sum(w << (32 * j) for j, w in enumerate(words[k : k + 12])) for k in range(0, len(words), 12)]


def test_pairing_programs_header_decodes(programs):
    """pairing_programs.cuh, the tables P1-P3 read, as the build writes it:
    its tables decode to the levels and operations of every program the
    tests below run, and its constants are the Montgomery forms of each
    kernel's (the Frobenius coefficients among them); every level holds
    operations within the frame's slots."""
    text = _build.generated()["pairing_programs.cuh"]
    assert text == PP.header_text(programs)

    def table(name):
        body = re.search(name + r"\[\d+\] = \{(.*?)\};", text, re.S).group(1)
        return [int(w, 0) for w in re.findall(r"0x[0-9a-f]+|\d+", body)]

    first, levels, ops, words = table("kProgramLevel"), table("kLevels"), table("kOps"), table("kConstWords")
    names = [(kernel, name) for kernel, k in programs.items() for name in k["programs"]]
    assert len(first) == len(names) + 1
    for p, (kernel, name) in enumerate(names):
        decoded = []
        for lv in range(first[p], first[p + 1]):
            begin, end = levels[lv] >> 2, levels[lv + 1] >> 2
            got = [PP.decode(ops[2 * i : 2 * i + 2]) for i in range(begin, end)]
            decoded.append((levels[lv] & 3, got))
        assert decoded == programs[kernel]["programs"][name].levels, (kernel, name)
    consts = [c for k in programs.values() for c in k["consts"]]
    assert _fp_words(words) == [_mont(c) for c in consts]
    gammas = {c % gf.P for g in gf._GAMMA_POWERS[1:] for c in g} - {0}
    assert gammas <= set(programs["p3"]["consts"]) and gammas <= set(programs["p1"]["consts"])
    for kernel, k in programs.items():
        assert k["slots"] <= PP.MAX_SLOTS
        for prog in k["programs"].values():
            for kind, ops in prog.levels:
                assert ops and all(0 <= s < k["slots"] for op in ops for s in [op[1]] + [slot for slot, _ in op[4]])
                assert kind != PP.LEVEL_INV or len(ops) == 1


def test_build_writes_generated_headers(monkeypatch, tmp_path):
    """_build.build() writes the generated headers into an include
    directory named by the sources' hash before it compiles, passes it to
    every nvcc, names the libraries by the same hash, and compiles
    nothing once the libraries exist (nvcc stood in for by a fake)."""
    calls = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            with open(self.out, "w") as fh:
                fh.write("lib")
            return "ptxas info", None

    monkeypatch.setenv("KZG_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    paths = _build.build()
    sources = {src for src, _ in _build.ENTRY_POINTS.values()}
    assert set(paths) == sources and len(calls) == len(sources)
    (include,) = tmp_path.glob("include-*")
    digest = include.name.removeprefix("include-")
    assert (include / "pairing_programs.cuh").read_text() == _build.generated()["pairing_programs.cuh"]
    assert not (pathlib.Path(_build.CSRC) / "pairing_programs.cuh").exists()
    for cmd in calls:
        assert cmd[cmd.index("-I") + 1] == str(include)
    assert all(pathlib.Path(p).name.endswith(f"-{digest}.so") and pathlib.Path(p).exists() for p in paths.values())
    assert _build.build() == paths and len(calls) == len(sources)


def test_p1_programs_match_golden(programs):
    """Each of P1's programs (one Fp12 function over the group) equals
    golden/field.py's function: the product, squaring, Granger-Scott
    squaring (its formula on any input), Frobenius, inversion (and
    inv(0) = 0) and the sparse line product."""
    a, b = rand_fp12(), rand_fp12()
    line = (rand_fp2(), rand_fp2(), rand_fp2())
    want = {
        "mul": gf.fp12_mul(a, b),
        "sqr": gf.fp12_sqr(a),
        "cyclo_sqr": gf.fp12_cyclo_sqr(a),
        "frobenius": gf.fp12_frobenius(a),
        "inv": gf.fp12_inv(a),
        "mul_by_line": gf.fp12_mul(a, _sparse_line_fp12(*line)),
    }
    assert set(want) == set(programs["p1"]["programs"]) == set(T.FP12_OPS)
    for op, w in want.items():
        bb = PP.nest(PP.flatten(line) + [0] * 6, (2, 3, 2)) if op == "mul_by_line" else b
        frame = _run(programs, "p1", [op], _frame(programs, "p1", {"A": a, "B": bb}))
        assert _reg(programs, "p1", frame, "Z") == w, op
    frame = _run(programs, "p1", ["inv"], _frame(programs, "p1", {"A": gf.FP12_ZERO}))
    assert _reg(programs, "p1", frame, "Z") == gf.FP12_ZERO


def test_p2_programs_match_replica(programs):
    """P2's two step programs equal one step of the golden replica (the
    square, tangent line and doubling; then the chord line and mixed add),
    and the whole loop over the bits of |x| (conjugated) equals the
    replica's Miller value."""
    p_g1 = gc.g1_mul(gc.G1_GENERATOR, 13)
    q = gc.g2_mul(gc.G2_GENERATOR, 7)
    f = rand_fp12()
    t, _ = _rand_proj_g2(3)
    regs = {"F": f, "T": t, "Q": q, "P": p_g1}
    f_dbl = gf.fp12_mul(gf.fp12_sqr(f), _sparse_line_fp12(*g_tangent(t, p_g1)))
    t_dbl = g_double(t)
    frame = _run(programs, "p2", ["dbl"], _frame(programs, "p2", regs))
    assert (_reg(programs, "p2", frame, "F"), _reg(programs, "p2", frame, "T")) == (f_dbl, t_dbl)
    frame = _run(programs, "p2", ["dbl_add"], _frame(programs, "p2", regs))
    f_add = gf.fp12_mul(f_dbl, _sparse_line_fp12(*g_chord(t_dbl, q, p_g1)))
    assert (_reg(programs, "p2", frame, "F"), _reg(programs, "p2", frame, "T")) == (f_add, g_madd(t_dbl, q))
    assert PP.p2_sequence() == ["dbl_add" if b else "dbl" for b in P._X_BITS]
    start = {"F": gf.FP12_ONE, "T": (q[0], q[1], gf.FP2_ONE), "Q": q, "P": p_g1}
    frame = _run(programs, "p2", PP.p2_sequence(), _frame(programs, "p2", start))
    assert gf.fp12_conj(_reg(programs, "p2", frame, "F")) == g_miller(p_g1, q)


def test_p3_programs_match_golden(programs):
    """P3's sequence of programs: with the bits (1, 0) its value is
    m^H for the easy part m of f0 f1 (as the plain composition test);
    with |x| the pairing check of two Miller values from P2's programs is
    one for e(P, Q) e(-P, Q) and not for e(P, Q) e(-P, 2Q)."""
    f0, f1 = rand_fp12(), rand_fp12()
    xs = -6
    h = (xs - 1) ** 2 * (xs + gf.P) * (xs**2 + gf.P**2 - 1) + 3
    x = gf.fp12_mul(f0, f1)
    m = gf.fp12_mul(gf.fp12_conj(x), gf.fp12_inv(x))
    m = gf.fp12_mul(gf.fp12_frobenius_n(m, 2), m)
    frame = _run(programs, "p3", ["easy"], _frame(programs, "p3", {"U": f0, "W1": f1}))
    assert all(_reg(programs, "p3", frame, r) == m for r in ("M", "ACC", "BASE"))
    frame = _run(programs, "p3", PP.p3_sequence((1, 0)), _frame(programs, "p3", {"U": f0, "W1": f1}))
    assert _reg(programs, "p3", frame, "U") == gf.fp12_pow(m, h)

    def miller(p_g1, q):
        start = {"F": gf.FP12_ONE, "T": (q[0], q[1], gf.FP2_ONE), "Q": q, "P": p_g1}
        return gf.fp12_conj(_reg(programs, "p2", _run(programs, "p2", PP.p2_sequence(), _frame(programs, "p2", start)), "F"))

    p_g1, q = gc.g1_mul(gc.G1_GENERATOR, 5), gc.G2_GENERATOR
    for q2, want in ((q, True), (gc.g2_mul(q, 2), False)):
        regs = {"U": miller(p_g1, q), "W1": miller(gc.g1_neg(p_g1), q2)}
        frame = _run(programs, "p3", PP.p3_sequence(P._ABS_X_BITS), _frame(programs, "p3", regs))
        assert (_reg(programs, "p3", frame, "U") == gf.FP12_ONE) is want
