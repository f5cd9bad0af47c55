"""The port's G1 layer (kzg_rust_tpu_torch.ops.curve, K3/K4's plain versions
on the CPU) against the JAX package's curve ops and Pallas kernels.

Points are golden points scaled by seeded random projective factors, so
every row is its own representation; the exception lanes P+P, P+(-P),
inf+Q and P+inf ride along.  Both packages use the Fp radix 2^384, so the
comparison is exact projective equality of the raw words.
"""

from __future__ import annotations

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kzg_rust_tpu.ops import curve as JC
from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import msm as JM
from kzg_rust_tpu.ops import pallas_kernels as PK
from kzg_rust_tpu.ops import verify_kernels as JV
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import curve as C
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import msm as M

TILE = 8  # the Pallas kernels' interpret-mode tile, as tests/test_ops_pallas.py
RR = L.FP.mont_r


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scaled(points, seed):
    """Golden affine points -> projective Montgomery ints (X, Y, Z) with a
    random nonzero factor per row (infinity -> (0, lam, 0))."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(len(points), 56), dtype=np.uint8).tobytes()
    rows = []
    for i, p in enumerate(points):
        lam = (int.from_bytes(raw[56 * i : 56 * i + 56], "little") % (P - 1) + 1) * RR % P
        rows.append([0, lam, 0] if p is None else [p[0] * lam % P, p[1] * lam % P, lam])
    return rows


def _both(rows):
    """Projective int rows -> (JAX [N, 3, 32] limbs, port [N, 3, 12] words)."""
    flat = [v for r in rows for v in r]
    jax_pts = JL.ints_to_limbs(32, flat).reshape(len(rows), 3, 32)
    port = L.to_device(L.FP, flat, "cpu").reshape(len(rows), 3, 12)
    return jnp.asarray(jax_pts), port


def _lanes():
    rng = np.random.default_rng(7)
    pts = [gc.g1_mul(gc.G1_GENERATOR, int(k)) for k in rng.integers(1, 1 << 62, size=4)]
    neg1 = (pts[1][0], (-pts[1][1]) % P)
    # 8 rows, the shape tests/test_ops_pallas.py compiles.  Exception lanes:
    # P + P, P + (-P), inf + Q, P + inf, inf + inf.
    ps = pts[:3] + [pts[0], pts[1], None, pts[2], None]
    qs = [pts[3], pts[2], pts[0]] + [pts[0], neg1, pts[3], None, None]
    return ps, qs


def test_proj_add_matches_xla_and_pallas():
    ps, qs = _lanes()
    jp, pp = _both(_scaled(ps, 1))
    jq, pq = _both(_scaled(qs, 2))
    want = np.asarray(JC.proj_add(jp, jq))
    assert (np.asarray(PK._make_proj_op(False, TILE)(jp, jq)) == want).all()
    got = C.proj_add(pp, pq)
    assert torch.equal(got, JS.points_from_jax(want))
    assert C.proj_to_points(got) == [gc.g1_add(p, q) for p, q in zip(ps, qs)]


def test_proj_double_matches_xla_and_pallas():
    ps, _ = _lanes()
    jp, pp = _both(_scaled(ps, 3))
    want = np.asarray(JC.proj_double(jp))
    assert (np.asarray(PK._make_proj_op(True, TILE)(jp, jp)) == want).all()
    got = C.proj_double(pp)
    assert torch.equal(got, JS.points_from_jax(want))
    out = torch.empty_like(pp)
    assert C.proj_double(pp, out=out) is out and torch.equal(out, got)
    assert C.proj_to_points(got) == [gc.g1_double(p) for p in ps]


def test_proj_double_chain_matches_jax():
    """The K4 chain (its plain version here) against the JAX package's
    proj_double iterated, word for word, infinity rows included."""
    ps, _ = _lanes()
    jp, pp = _both(_scaled(ps, 5))
    got = C.proj_double_chain(pp, 5)
    assert got.shape == (5, 8, 3, 12)
    acc = jp
    for k in range(5):
        acc = JC.proj_double(acc)
        assert torch.equal(got[k], JS.points_from_jax(np.asarray(acc)))
    assert torch.equal(C.proj_double_chain(pp, 1)[0], C.proj_double(pp))
    out = torch.empty_like(got)
    assert C.proj_double_chain(pp, 5, out=out) is out and torch.equal(out, got)
    assert C.proj_to_points(got[4]) == [gc.g1_mul_unsafe(p, 32) if p else None for p in ps]


def _c_params(params: str) -> list:
    """C parameter list -> ctypes argtypes: a pointer, long long or int each."""
    kinds = []
    for param in (p.strip() for p in params.split(",")):
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif param.startswith("long long "):
            kinds.append(ctypes.c_longlong)
        else:
            assert param.startswith("int "), param
            kinds.append(ctypes.c_int)
    return kinds


def test_entry_points_match_csrc():
    """Every extern "C" function of csrc/*.cu (macro-made ones included) is
    in _build.ENTRY_POINTS with its source and one argtype per parameter;
    a wrong argtype would cut a pointer to 32 bits without an error."""
    found = {}
    for path in sorted(pathlib.Path(_build.CSRC).glob("*.cu")):
        text = path.read_text().replace("\\\n", " ")
        for m in re.finditer(r'extern "C" int (kzg_\w+)\(([^)]*)\)', text):
            found[m.group(1)] = (path.name, _c_params(m.group(2)))
        macros = re.finditer(r'#define (\w+)\(name,[^)]*\)\s+extern "C" int name\(([^)]*)\)', text)
        for m in macros:
            for call in re.finditer(r"^" + m.group(1) + r"\((kzg_\w+),", text, re.M):
                found[call.group(1)] = (path.name, _c_params(m.group(2)))
    assert "kzg_proj_double_chain" in found and "kzg_fp_mont_mul" in found
    assert found == {name: (src, list(types)) for name, (src, types) in _build.ENTRY_POINTS.items()}


def test_point_codecs_and_neg_match_jax():
    ps, _ = _lanes()
    port = C.points_to_proj(ps)
    assert torch.equal(port, JS.points_from_jax(JC.points_to_proj(ps)))
    assert C.proj_to_points(port) == ps
    neg = C.point_neg(port)
    assert torch.equal(neg, JS.points_from_jax(np.asarray(JC.point_neg(jnp.asarray(JC.points_to_proj(ps))))))
    assert C.proj_to_points(neg) == [gc.g1_neg(p) for p in ps]


def test_sum_points_matches_reduce_axis0():
    """The K3 tree sum keeps verify_kernels._reduce_axis0's order, so even
    the projective words agree; odd widths carry their last row."""
    ps, qs = _lanes()
    rows = _scaled(ps + qs[:7], 4)  # 15 points: odd widths at every level
    jp, pp = _both(rows)
    want = np.asarray(JV._reduce_axis0(jp.reshape(5, 3, 3, 32)))
    got = C.sum_points(pp.reshape(5, 3, 3, 12))
    assert torch.equal(got, JS.points_from_jax(want))
    total = None
    for p in (ps + qs[:7])[0::3]:
        total = gc.g1_add(total, p)
    assert C.proj_to_points(got[:1]) == [total]


def test_window_select_matches_jax():
    """Signed base-16 recoding and the generator-table select, against the
    JAX package's msm on its own table."""
    scalars = [0, 1, gc.R - 1, 0x1234567890ABCDEF << 100]
    want = JM.recode_signed_digits(scalars, len(scalars))
    assert (M.recode_signed_digits(scalars, len(scalars)) == want).all()
    rng = np.random.default_rng(8)
    table_pts = [gc.g1_mul(gc.G1_GENERATOR, int(k)) for k in rng.integers(1, 1 << 62, size=2 * 8 * 3)]
    jtable = jnp.asarray(JC.points_to_proj(table_pts).reshape(2, 8, 3, 3, 32))
    digits = np.array([[0, -3, 8], [-8, 5, 1]], dtype=np.int32)
    jsel = np.asarray(JM.select_window_points(jtable, jnp.asarray(digits)))
    sel = M.select_window_points(JS.points_from_jax(np.asarray(jtable)), torch.from_numpy(digits))
    assert torch.equal(sel, JS.points_from_jax(jsel))
