"""The port's extension tower (kzg_rust_tpu_torch.ops.tower) against the
JAX package's ops/tower.py and the golden model.

Seeded random elements (numpy) in a batch of distinct lanes go through
both packages' functions, one eager JAX call each (``jax.disable_jit()``:
a compiled tower program takes minutes on XLA-CPU); the JAX values come
over with ``ops/jax_state.py`` and must equal the port's word for word.
The inversions, the is-one test and the codecs hold against the golden
model; kernel P1's plain version (``fp12_op``) against the public
functions; and the constants of ``csrc/tower.cuh`` against the golden
ones.  Comparisons are exact.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
from gc import collect as collect_garbage

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import tower as JT
from kzg_rust_tpu.ops.fields import FP as JFP
from kzg_rust_tpu_torch.golden import field as gf
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import tower as T

B = 3  # lanes of every batch
rng = np.random.default_rng(0x70E4)


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


def _ints(n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(48), "little") % gf.P for _ in range(n)]


def _leaf(values) -> np.ndarray:
    """Field ints (Montgomery values) -> the JAX package's [B, 32] limbs."""
    return np.stack([JL.int_to_limbs(JFP.nlimbs, v) for v in values]).astype(np.uint32)


def _rand(levels: int):
    """A random batch of B elements as nested tuples of JAX limb arrays
    (numpy): 0 levels Fp, 1 Fp2, 2 Fp6, 3 Fp12."""
    if levels == 0:
        return _leaf(_ints(B))
    return tuple(_rand(levels - 1) for _ in range(3 if levels == 2 else 2))


def _tmap(fn, x):
    return tuple(_tmap(fn, p) for p in x) if isinstance(x, tuple) else fn(x)


_FROM_JAX = {0: JS.fp_from_jax, 1: JS.fp2_from_jax, 2: JS.fp6_from_jax, 3: JS.fp12_from_jax}


def _levels(x) -> int:
    return 0 if not isinstance(x, tuple) else 1 + _levels(x[0])


def _port(x):
    return _FROM_JAX[_levels(x)](x)


def _jax(x):
    return _tmap(jnp.asarray, x)


def _same(port, jax_out) -> bool:
    """Port tuples == JAX tuples word for word (the shared Fp radix)."""
    want = _port(_tmap(np.asarray, jax_out))
    flat_p, flat_w = [], []
    _tmap(flat_p.append, port)
    _tmap(flat_w.append, want)
    return len(flat_p) == len(flat_w) and all(torch.equal(p.contiguous(), w) for p, w in zip(flat_p, flat_w))


# (function name, the tuple levels of its operands): each runs once in both
# packages on the same seeded batch.
CASES = [
    ("fp2_add", (1, 1)),
    ("fp2_sub", (1, 1)),
    ("fp2_neg", (1,)),
    ("fp2_conj", (1,)),
    ("fp2_mul", (1, 1)),
    ("fp2_sqr", (1,)),
    ("fp2_mul_fp", (1, 0)),
    ("fp2_mul_by_xi", (1,)),
    ("fp2_double", (1,)),
    ("fp6_add", (2, 2)),
    ("fp6_sub", (2, 2)),
    ("fp6_neg", (2,)),
    ("fp6_mul", (2, 2)),
    ("fp6_sqr", (2,)),
    ("fp6_mul_by_v", (2,)),
    ("fp6_mul_fp2", (2, 1)),
    ("fp12_mul", (3, 3)),
    ("fp12_sqr", (3,)),
    ("fp12_cyclo_sqr", (3,)),
    ("fp12_conj", (3,)),
    ("fp12_frobenius", (3,)),
]


@pytest.mark.parametrize("name,levels", CASES, ids=[c[0] for c in CASES])
def test_tower_op_matches_jax(name, levels):
    """Each Fp2, Fp6 and Fp12 function on a batch equals the JAX
    package's (the Granger-Scott squaring on arbitrary elements: both
    evaluate its formula)."""
    args = [_rand(k) for k in levels]
    got = getattr(T, name)(*(_port(a) for a in args))
    with jax.disable_jit():
        want = getattr(JT, name)(*(_jax(a) for a in args))
    assert _same(got, want)


def _golden(x, lane: int):
    """Lane ``lane`` of a port tuple -> golden nested ints (canonical)."""
    if isinstance(x, tuple):
        return tuple(_golden(p, lane) for p in x)
    return L.words_to_ints(L.from_mont(L.FP, x[lane : lane + 1]))[0]


def test_inversions_and_is_one_match_golden():
    """fp2_inv, fp6_inv and fp12_inv against the golden inverses, lane by
    lane, inv(0) = 0 included; fp12_is_one on one, a random element and a
    unit of norm one; the codecs round-trip."""
    a2, a6, a12 = _port(_rand(1)), _port(_rand(2)), _port(_rand(3))
    a2 = (a2[0].clone(), a2[1].clone())
    a2[0][0] = 0
    a2[1][0] = 0
    inv2, inv6, inv12 = T.fp2_inv(a2), T.fp6_inv(a6), T.fp12_inv(a12)
    for lane in range(B):
        if lane:  # the golden inverse refuses 0
            assert _golden(inv2, lane) == gf.fp2_inv(_golden(a2, lane))
        assert _golden(inv6, lane) == gf.fp6_inv(_golden(a6, lane))
        assert _golden(inv12, lane) == gf.fp12_inv(_golden(a12, lane))
    assert _golden(inv2, 0) == (0, 0)
    one = T.fp12_from_golden(gf.FP12_ONE, (B,))
    assert T.fp12_is_one(one).tolist() == [True] * B
    assert T.fp12_is_one(a12).tolist() == [False] * B
    m = T.fp12_mul(T.fp12_conj(a12), inv12)  # the easy part's image: norm one
    cyc = T.fp12_mul(T.fp12_frobenius_n(m, 2), m)
    g = _golden(cyc, 1)
    assert T.fp12_is_one(T.fp12_mul(cyc, T.fp12_conj(cyc))).tolist() == [True] * B  # norm one
    assert T.fp12_to_golden(T.fp12_from_golden(g)) == g
    assert T.fp12_to_golden(T.pack(cyc)[1]) == g
    assert T.fp12_to_golden(T.fp12_cyclo_sqr(T.fp12_from_golden(g))) == gf.fp12_cyclo_sqr(g) == gf.fp12_sqr(g)


def test_fp12_op_plain_matches_golden():
    """Kernel P1's wrapper on a CPU tensor runs its plain version: each op
    code's value in every lane equals the golden function (the line
    product the golden product by the sparse line element, the
    Granger-Scott squaring its formula); it refuses unknown ops, a missing
    or extra operand and wrong shapes."""
    a, b, c = T.pack(_port(_rand(3))), T.pack(_port(_rand(3))), T.pack(_port(_rand(2)))
    golden = {
        "mul": lambda x, y: gf.fp12_mul(x, y),
        "sqr": lambda x, y: gf.fp12_sqr(x),
        "cyclo_sqr": lambda x, y: gf.fp12_cyclo_sqr(x),
        "frobenius": lambda x, y: gf.fp12_frobenius(x),
        "inv": lambda x, y: gf.fp12_inv(x),
        "mul_by_line": lambda x, y: gf.fp12_mul(x, ((y[0], gf.FP2_ZERO, gf.FP2_ZERO), (gf.FP2_ZERO, y[1], y[2]))),
    }
    assert sorted(T.FP12_OPS) == sorted(golden)
    for op, fn in golden.items():
        y = {"mul": b, "mul_by_line": c}.get(op)
        got = T.fp12_op(op, a, y)
        for lane in range(B):
            other = None if y is None else _golden(T.unpack(y, 3 if op == "mul" else 2), lane)
            assert T.fp12_to_golden(got[lane]) == fn(_golden(T.unpack(a, 3), lane), other), (op, lane)
    for bad in (lambda: T.fp12_op("pow", a), lambda: T.fp12_op("mul", a), lambda: T.fp12_op("sqr", a, b), lambda: T.fp12_op("mul_by_line", a, c[..., :2, :, :]), lambda: T.fp12_op("sqr", a[..., :6])):
        with pytest.raises(ValueError):
            bad()


def _source(name: str) -> str:
    return (pathlib.Path(_build.CSRC) / name).read_text()


def _words_of(block: str) -> list[int]:
    """Every 0x...u word of a C initializer, in order."""
    return [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", block)]


def _fp_values(words: list[int]) -> list[int]:
    assert len(words) % 12 == 0
    return [sum(w << (32 * j) for j, w in enumerate(words[k : k + 12])) for k in range(0, len(words), 12)]


def test_tower_source_constants_match_golden():
    """csrc/tower.cuh's immediates: mont(1) and the Fermat inversion's
    digits of p - 2 with their largest digit; the programs' constants
    (pairing_programs.cuh as the build generates it) hold the Frobenius
    coefficients gamma^1..gamma^5 of golden/field.py (c0 and c1) and the
    norms of gamma^k that frob^2 multiplies by; P1's op codes are the
    wrapper's, in the order of its programs."""
    text = _source("tower.cuh")
    mont = lambda v: v * L.FP.mont_r % gf.P  # noqa: E731
    one = re.search(r"__constant__ Fe kOneMont = \{(.*?)\};", text, re.S).group(1)
    assert _fp_values(_words_of(one)) == [mont(1)]
    programs_h = _build.generated()["pairing_programs.cuh"]
    consts = set(_fp_values(_words_of(re.search(r"kConstWords\[\d+\] = \{(.*?)\};", programs_h, re.S).group(1))))
    gammas = [c for g in gf._GAMMA_POWERS[1:] for c in g if c] + [(g[0] ** 2 + g[1] ** 2) % gf.P for g in gf._GAMMA_POWERS[1:]]
    assert {mont(c) for c in gammas} <= consts
    programs = re.findall(r"^  kP1(\w+) = (\d+),$", programs_h, re.M)
    assert [name for name, _ in programs] == ["".join(p.capitalize() for p in op.split("_")) for op in T.FP12_OPS]
    digits = re.search(r"__constant__ PowDigits kInvDigits = \{\s*\{([^}]*)\},\s*(\d+),\s*(\d+)\}", text, re.S)
    d = [int(x) for x in digits.group(1).split(",")]
    assert d == list(L.pow_digits(gf.P - 2)) and int(digits.group(2)) == len(d) and int(digits.group(3)) == max(d)
    assert int(re.search(r"constexpr int kInvTop = (\d+);", text).group(1)) == max(d)
    pk = _source("pairing_kernels.cu")
    ops = {name: int(v) for name, v in re.findall(r"kOp(\w+) = (\d)", pk)}
    assert {op: ops["".join(p.capitalize() for p in op.split("_"))] for op in T.FP12_OPS} == T.FP12_OPS
