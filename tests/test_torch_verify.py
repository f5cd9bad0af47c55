"""The port's verification stages (kzg_rust_tpu_torch.ops.verify_kernels, on
the plain versions of K1-K4 and of stage 1's kernels A and B) against the
JAX package's jitted stage programs, at the shapes
tests/test_batch_pipeline.py already compiles (4 padded blobs: 8 stage-1
rows, the minimal preset's 4-element blobs).

Inputs come from seeded generators and go through both packages; every
comparison is exact: flags, projective words where the two compute the
same representation, canonical ys, and affine points where the
summation orders differ.  Stage 1's rows are checked one by one against
the JAX package's decompression and subgroup-check programs and the
golden model; kernels A and B themselves run only on a card
(chip_smoke.py holds them against these plain versions there), so here
their constants are parsed from the CUDA source and their wrappers'
checks are exercised.
"""

from __future__ import annotations

import ctypes
import itertools
import random
import re
import types
from gc import collect as collect_garbage

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kzg_rust_tpu.ops import limbs as JL
from kzg_rust_tpu.ops import msm as JM
from kzg_rust_tpu.ops import protocol_kernels as JPK
from kzg_rust_tpu.ops import verify_kernels as JV
from kzg_rust_tpu.presets import MINIMAL as J_MINIMAL
from kzg_rust_tpu.utils.testing import make_insecure_setup as j_make_insecure_setup
from kzg_rust_tpu_torch.backends.golden_backend import GoldenBackend
from kzg_rust_tpu_torch.errors import BadArgs
from kzg_rust_tpu_torch.golden import curve as gc
from kzg_rust_tpu_torch.golden.field import P, R, fp_sqrt
from kzg_rust_tpu_torch.ops import _build
from kzg_rust_tpu_torch.ops import curve as C
from kzg_rust_tpu_torch.ops import glv
from kzg_rust_tpu_torch.ops import jax_state as JS
from kzg_rust_tpu_torch.ops import limbs as L
from kzg_rust_tpu_torch.ops import msm as M
from kzg_rust_tpu_torch.ops import protocol_kernels as PKT
from kzg_rust_tpu_torch.ops import verify_kernels as V
from kzg_rust_tpu_torch.presets import MAINNET, MINIMAL
from kzg_rust_tpu_torch.utils.domain import compute_roots_of_unity
from kzg_rust_tpu_torch.utils.testing import make_insecure_setup

rng = random.Random(0x7E571)


@pytest.fixture(autouse=True, scope="module")
def _worker_resources():
    """The plain versions run many small tensor ops; one intra-op thread per
    test worker keeps parallel workers from oversubscribing the cores.  At
    the end the module's compiled JAX programs are dropped and the freed
    heap goes back to the OS, as tests/test_torch_msm.py does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    collect_garbage()
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)  # glibc
    if trim is not None:
        trim(0)


def _non_subgroup_point():
    while True:
        x = rng.randrange(P)
        y = fp_sqrt((x * x * x + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            return (x, y)


def _valid_rows(k):
    return [gc.g1_compress(gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R))) for _ in range(k)]


INF = b"\xc0" + b"\x00" * 47
X_OVER_P = bytes([0x80 | (P >> 376)]) + P.to_bytes(48, "big")[1:]


@pytest.fixture(scope="module")
def rows():
    valid = _valid_rows(6) + [INF, INF]
    bad = list(valid)
    bad[1] = b"\x11" * 48  # compression flag clear
    bad[2] = gc.g1_compress(_non_subgroup_point())
    bad[3] = X_OVER_P  # x == p: not canonical
    bad[4] = b"\xc0" + b"\x00" * 46 + b"\x01"  # infinity flag with a nonzero payload
    bad[5] = bytes([valid[5][0] ^ 0x20]) + valid[5][1:]  # the other square root
    return valid, bad


def _comp(rows_):
    return np.frombuffer(b"".join(rows_), np.uint8).reshape(len(rows_), 48).copy()


@pytest.fixture(scope="module")
def jax_stage1(rows):
    """The JAX package's stage 1 on both 8-row inputs (one compiled program)."""
    return [tuple(np.asarray(t) for t in JV.batch_points_kernel(jnp.asarray(_comp(r)))) for r in rows]


def test_batch_points_matches_jax(rows, jax_stage1):
    for rows_, (jb, jb2, jflags) in zip(rows, jax_stage1):
        bases, bases2, flags = V.batch_points(torch.from_numpy(_comp(rows_)))
        assert flags.tolist() == jflags.tolist()
        # Same decompression and doubling formulas: the same projective words.
        assert torch.equal(bases, JS.points_from_jax(jb))
        assert torch.equal(bases2, JS.points_from_jax(jb2))
    assert jax_stage1[0][2].tolist() == [1, 1]
    assert jax_stage1[1][2].tolist() == [0, 0]


def test_stage1_row_flags_match_golden(rows):
    """Per row: decode flags against golden g1_uncompress, and the subgroup
    check against golden g1_in_subgroup; bases against golden multiples."""
    _, bad = rows
    comp = torch.from_numpy(_comp(bad))
    points, ok = V.g1_uncompress_points(comp)
    want_ok, want_pts = [], []
    for r in bad:
        try:
            want_pts.append(gc.g1_uncompress(r))
            want_ok.append(True)
        except BadArgs:
            want_pts.append(None)
            want_ok.append(False)
    assert ok.tolist() == want_ok
    got = C.proj_to_points(points)
    assert [g for g, k in zip(got, want_ok) if k] == [p for p, k in zip(want_pts, want_ok) if k]
    bases, bases2 = V.bases_chain(points)
    sub = V.subgroup_check_from_bases(points, bases, bases2)
    for i, k in enumerate(want_ok):
        if k:
            assert sub[i].item() == gc.g1_in_subgroup(want_pts[i])
    j = 5
    assert C.proj_to_points(bases[j][:1]) == [gc.g1_mul_unsafe(want_pts[0], 4**j)]
    assert C.proj_to_points(bases2[j][:1]) == [gc.g1_mul_unsafe(want_pts[0], 2 * 4**j)]


def _blob_bytes(n_blobs, fe, noncanonical_at=None):
    data = bytearray()
    for b in range(n_blobs):
        for i in range(fe):
            data += (b"\xff" * 32) if (b, i) == noncanonical_at else (b"\x00" + rng.randbytes(31))
    return np.frombuffer(bytes(data), np.uint8).reshape(n_blobs, fe, 32).copy()


@pytest.mark.parametrize(
    "noncanonical_at",
    [None, (2, 1), (3, MINIMAL.field_elements_per_blob - 1)],
    ids=["canonical", "noncanonical", "noncanonical-last-row-of-last-blob"],
)
def test_bary_matches_jax_minimal(noncanonical_at):
    """Blob ingest, canonicality flag and the barycentric evaluation on the
    minimal preset, with the port's own FrContext and with the JAX
    package's carried over by jax_state."""
    jset = j_make_insecure_setup(J_MINIMAL)
    jctx = JPK.FrContext.build(jset)
    blobs = _blob_bytes(4, MINIMAL.field_elements_per_blob, noncanonical_at)
    xs = [rng.randrange(R) for _ in range(4)]
    jys, jok = JV.bary_batch_from_bytes_kernel(
        jctx.n, jctx.roots_m, jctx.roots_m2, jctx.inv_n_m, jnp.asarray(blobs), jnp.asarray(JL.ints_to_limbs(22, xs))
    )
    ctx = PKT.FrContext.build(make_insecure_setup(MINIMAL), "cpu")
    carried = JS.fr_context_from_jax(jctx.n, np.asarray(jctx.roots_m), np.asarray(jctx.roots_m2), np.asarray(jctx.inv_n_m))
    for c in (ctx, carried):
        ys, ok = V.bary_batch_from_bytes(c, torch.from_numpy(blobs), L.to_device(L.FR, xs, "cpu"))
        assert bool(ok) == bool(jok) == (noncanonical_at is None)
        if noncanonical_at is None:
            assert L.words_to_ints(ys) == JL.limbs_to_ints(np.asarray(jys))
    assert torch.equal(carried.roots_m2, ctx.roots_m2) and torch.equal(carried.inv_n_m, ctx.inv_n_m)


def test_bary_matches_golden_mainnet():
    """Two mainnet-width blobs (4096 elements) against the golden
    barycentric evaluation."""
    settings = types.SimpleNamespace(preset=MAINNET, roots_of_unity=compute_roots_of_unity(12))
    blobs = _blob_bytes(2, 4096)
    xs = [rng.randrange(R) for _ in range(2)]
    ctx = PKT.FrContext.build(settings, "cpu")
    ys, ok = V.bary_batch_from_bytes(ctx, torch.from_numpy(blobs), L.to_device(L.FR, xs, "cpu"))
    assert bool(ok)
    golden = GoldenBackend()
    for b in range(2):
        evals = [int.from_bytes(blobs[b, i].tobytes(), "big") for i in range(4096)]
        assert L.words_to_ints(ys[b : b + 1]) == [golden.barycentric_eval(settings, evals, xs[b])]


def test_stage2_matches_jax(rows, jax_stage1):
    """The RLC combination over the JAX package's own stage-1 bases and
    generator table (carried by jax_state) and over the port's own table:
    the same affine points as batch_stage2_kernel."""
    jb, jb2, _ = jax_stage1[0]
    n = 4
    r_powers = [rng.randrange(R) for _ in range(n)]
    r_times_z = [rng.randrange(R) for _ in range(n)]
    digits = V.stage2_digits(n, r_powers, r_times_z)
    assert (digits == JV.stage2_digits(n, r_powers, r_times_z)).all()
    sy = M.recode_signed_digits([rng.randrange(R)], 1)
    jtable = JV.build_generator_table()
    want = JV.batch_stage2_kernel(
        jnp.asarray(jb), jnp.asarray(jb2), jnp.asarray(digits), jtable, jnp.asarray(sy, dtype=jnp.int32)
    )
    want_aff = C.proj_to_points(JS.points_from_jax(np.asarray(want)))
    table = V.build_generator_table("cpu")
    assert C.proj_to_points(table.reshape(-1, 3, 12)) == C.proj_to_points(
        JS.gen_table_from_jax(np.asarray(jtable)).reshape(-1, 3, 12)
    )
    for t in (JS.gen_table_from_jax(np.asarray(jtable)), table):
        got = V.batch_stage2(
            JS.points_from_jax(jb), JS.points_from_jax(jb2), torch.from_numpy(digits), t, torch.from_numpy(sy)
        )
        assert C.proj_to_points(got) == want_aff
    assert (M.recode_signed_digits([5, R - 1], 2) == JM.recode_signed_digits([5, R - 1], 2)).all()


# ---------------------------------------------------------------------------
# Stage 1 row by row: kernel A's and kernel B's rules (their plain versions)
# ---------------------------------------------------------------------------


def _x_row(x, bits=0x80):
    row = bytearray(x.to_bytes(48, "big"))
    row[0] |= bits
    return bytes(row)


@pytest.fixture(scope="module")
def edge_rows():
    """The rows the bad set lacks: x = p - 1, an x whose x^3 + 4 is not a
    square, infinity with the sign bit set, infinity without the compression
    bit, a valid point in both signs, a point on the curve off the subgroup,
    and x = 0 (the point (0, 2), off the subgroup)."""
    prng = random.Random(0x57A6E1)
    nonsquare = next(x for x in itertools.count(1) if fp_sqrt((x**3 + 4) % P) is None)
    valid = gc.g1_compress(gc.g1_mul(gc.G1_GENERATOR, prng.randrange(1, R)))
    while True:
        x = prng.randrange(P)
        y = fp_sqrt((x**3 + 4) % P)
        if y is not None and not gc.g1_in_subgroup((x, y)):
            break
    return [
        _x_row(P - 1),
        _x_row(nonsquare),
        b"\xe0" + b"\x00" * 47,
        b"\x40" + b"\x00" * 47,
        valid,
        bytes([valid[0] ^ 0x20]) + valid[1:],
        gc.g1_compress((x, y)),
        _x_row(0),
    ]


@pytest.fixture(scope="module")
def row_sets(rows, edge_rows):
    return {"bad": rows[1], "edge": edge_rows}


def _golden_rows(rows_):
    """Per row: (decodes, affine point, in the subgroup) by the golden model."""
    out = []
    for r in rows_:
        try:
            pt = gc.g1_uncompress(r)
        except BadArgs:
            out.append((False, None, None))
            continue
        out.append((True, pt, gc.g1_in_subgroup(pt)))
    return out


@pytest.mark.parametrize("which", ["bad", "edge"])
def test_stage1_rows_match_jax_and_golden(row_sets, which):
    """Kernel A's rules row by row: ok equals the JAX g1_uncompress_kernel's
    and the golden decoder's, and every row that decodes has the JAX
    package's projective words and the golden point.  Kernel B's rules: on
    every row that decodes, the subgroup bit equals the JAX
    subgroup_check_kernel's and golden g1_in_subgroup.  The stage's flags
    equal the JAX batch_points_kernel's."""
    rows_ = row_sets[which]
    comp = _comp(rows_)
    jpts, jok = (np.asarray(t) for t in JV.g1_uncompress_kernel(jnp.asarray(comp)))
    jsub = np.asarray(JV.subgroup_check_kernel(jnp.asarray(jpts)))
    jflags = np.asarray(JV.batch_points_kernel(jnp.asarray(comp))[2])
    want = _golden_rows(rows_)

    points, ok = V.g1_uncompress_points(torch.from_numpy(comp))
    assert ok.tolist() == jok.tolist() == [w[0] for w in want]
    jwords = JS.points_from_jax(jpts)
    affine = C.proj_to_points(points)
    bases, bases2 = V.bases_chain(points)
    sub = V.subgroup_check_from_bases(points, bases, bases2).tolist()
    for i, (decodes, pt, in_sub) in enumerate(want):
        if decodes:
            assert torch.equal(points[i], jwords[i]), i
            assert affine[i] == pt, i
            assert sub[i] == bool(jsub[i]) == in_sub, i
    assert V.batch_points(torch.from_numpy(comp))[2].tolist() == jflags.tolist()
    assert which != "edge" or set(ok.tolist()) == set(sub) == {True, False}


def _stage1_source():
    return open(f"{_build.CSRC}/stage1_kernels.cu").read()


@pytest.fixture(scope="module")
def z2_sums():
    """[z^2]P's tree over 17 parts as kernel B takes them ([17, 3, 3, 12]
    projective words, each row its own representation: a random Z), with a
    point added to itself, one to its negation and infinity among them:
    the port's curve.sum_points, which the plain version runs, and the JAX
    package's _reduce_axis0 (eager, the stage's own tree)."""
    base = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(16)]
    pts = base + [base[3]]
    pts[9] = gc.g1_neg(base[1])  # level 1 adds part 9 onto part 1: P + (-P)
    pts[12] = base[4]  # and part 12 onto part 4: P + P
    pts[6] = None
    vals = []
    for i, p in enumerate(pts * 3):
        lam = rng.randrange(1, P) * L.FP.mont_r % P
        vals += [0, lam, 0] if p is None else [p[0] * lam % P, p[1] * lam % P, lam]
    parts = torch.from_numpy(L.ints_to_words(L.FP.nwords, vals)).reshape(3, 17, 3, 12).transpose(0, 1).contiguous()
    jparts = JL.ints_to_limbs(32, vals).reshape(3, 17, 3, 32).transpose(1, 0, 2, 3)
    want = JS.points_from_jax(np.asarray(JV._reduce_axis0(jnp.asarray(jparts))))
    return C.sum_points(parts, add=C.proj_add_plain), want


@pytest.mark.parametrize("lanes", [(8, 8), (8, 4), (8, 2), (2, 2), (4, 1)], ids=lambda v: f"{v[0]}x{v[1]}")
def test_stage1_kernel_digits_match(lanes, z2_sums):
    """Kernel B's compile-time digits are the signed base-4 recoding of z^2
    that the plain version and the JAX package use (17 nonzero).  The
    plain version's tree (curve.sum_points) gives [z^2]P the words of the
    JAX _reduce_axis0 on the same 17 parts; the entry point dispatches the
    variant (lanes an add, groups a point); subgroup_lanes takes 8 x 8 up
    to 2 points an SM, 8 x 4 up to 8, 8 x 2 up to 16, then 2 x 2."""
    text = _stage1_source()
    body = re.search(r"constexpr int kZ2Digits\[kWindows\] = \{([^}]*)\}", text).group(1)
    digits = [int(d) for d in body.replace("\n", " ").split(",")]
    want = glv.recode_base4_signed([glv.Z2])[:, 0].tolist()
    assert digits == want == V._Z2_DIGITS.tolist() == JV._Z2_DIGITS.tolist()
    assert sum(1 for d in digits if d) == int(re.search(r"constexpr int kParts = (\d+);", text).group(1))
    assert sum(d * 4**j for j, d in enumerate(digits)) == glv.Z2

    got, jax_sum = z2_sums
    assert torch.equal(got, jax_sum)
    assert C.proj_to_points(got)[0] is not None
    assert lanes in V.SUBGROUP_LANES
    width, groups = lanes
    if groups == 1:
        assert re.search(rf"case {width}0{groups}:\s*switch \(block_threads\(kLanes \* n\)\)", text)
        assert int(re.search(r"constexpr int kLanes = (\d+);", text).group(1)) == width
    else:
        assert f"case {width}0{groups}: return launch_subgroup_tree<{width}, {groups}>(" in text
    widths = (128, 264, 265, 1056, 1057, 2112, 2113, 8192)
    want = [(8, 8), (8, 8), (8, 4), (8, 4), (8, 2), (8, 2), (2, 2), (2, 2)]
    assert [V.subgroup_lanes(n, 132) for n in widths] == want


def test_stage1_kernel_constants_match():
    """The immediates of csrc/stage1_kernels.cu are the Python constants:
    R^2, mont(1), mont(4), (p + 1) / 2, mont(beta) and the square root's
    exponent (p + 1) / 4; both entry points build from that file."""
    text = _stage1_source()
    consts = {}
    for name, body in re.findall(r"KZG_CONSTANT\((\w+), (0x[^)]*)\)", text):
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        consts[name] = sum(w << (32 * k) for k, w in enumerate(words))
    assert consts == {
        "r2_mod_p": L.FP.r2,
        "one_mont": L.FP.mont_r,
        "b4_mont": V._B4_MONT,
        "half_p1": V._HALF_P1,
        "beta_mont": C.BETA_MONT,
    }
    body = re.search(r"constexpr uint32_t kSqrtExp\[Fp::N\] = \{([^}]*)\}", text).group(1)
    assert sum(int(w.strip().rstrip("u"), 16) << (32 * k) for k, w in enumerate(body.split(","))) == (P + 1) // 4
    for entry in ("kzg_g1_decompress", "kzg_g1_subgroup_check"):
        assert _build.ENTRY_POINTS[entry][0] == "stage1_kernels.cu"
        assert f'extern "C" int {entry}(' in text


@pytest.mark.parametrize("lanes", [4, 2, 1])
def test_stage1_sqrt_chain_fits_kernel_a(lanes):
    """Kernel A takes the square root's chain as a parameter: the chain the
    wrapper passes (verify_kernels.SQRT_CHAIN) fits the kernel's SqrtChain
    (steps, entries, squarings a step below 256, step 0 loading a nonzero
    entry alone) and makes the kernel's kSqrtExp, which the entry point
    checks it against; each of the lanes a point that the wrapper passes is
    one the entry point takes, and the wrapper picks 4 lanes up to one warp
    a sub-partition of the 132 SMs, then 2."""
    text = _stage1_source()
    c = V.SQRT_CHAIN
    max_steps = int(re.search(r"constexpr int kChainMaxSteps = (\d+);", text).group(1))
    max_entries = int(re.search(r"constexpr int kChainMaxEntries = (\d+);", text).group(1))
    assert len(c.steps) <= max_steps and 1 <= c.entries <= max_entries
    assert c.steps[0][0] == 0 and 1 <= c.steps[0][1] <= c.entries
    assert all(0 <= sq < 256 and 0 <= idx <= c.entries for sq, idx in c.steps)
    body = re.search(r"constexpr uint32_t kSqrtExp\[Fp::N\] = \{([^}]*)\}", text).group(1)
    assert c.exponent() == sum(int(w.strip().rstrip("u"), 16) << (32 * k) for k, w in enumerate(body.split(",")))
    code = c.to_bytes()
    assert len(code) == 1 + 2 * len(c.steps) and code[0] == c.entries
    assert lanes in V.DECOMPRESS_LANES
    assert f"case {lanes}: return launch_decompress_lanes<{lanes}>" in text
    widths = (128, 1024, 4224, 4225, 8192, 8448, 8449)
    assert [V.decompress_lanes(n, 132) for n in widths] == [4, 4, 4, 2, 2, 2, 2]


def test_stage1_wrappers_check_their_operands(rows):
    """Wrong types and shapes raise; on a tensor off the CPU the wrappers
    launch kernels A and B or raise, and never take the plain version (the
    meta device has no kernels: the launch refuses it, and nothing is
    counted)."""
    comp = torch.from_numpy(_comp(rows[0]))
    for bad in (comp.to(torch.int32), comp[:, :47], comp[0]):
        with pytest.raises(ValueError, match="compressed"):
            V.g1_uncompress_points(bad)
        with pytest.raises(ValueError, match="compressed"):
            V.batch_points(bad)
    points, _ = V.g1_uncompress_points(comp)
    bases, bases2 = V.bases_chain(points)
    with pytest.raises(ValueError, match="window bases"):
        V.subgroup_check_from_bases(points, bases[:-1], bases2[:-1])
    with pytest.raises(ValueError, match="window bases"):
        V.subgroup_check_from_bases(points, bases.to(torch.int64), bases2)
    with pytest.raises(ValueError, match="points"):
        V.subgroup_check_from_bases(points[None], bases[:, None], bases2[:, None])

    _build.reset_launches()
    meta = comp.to("meta")
    with pytest.raises(ValueError, match="contiguous"):
        V.g1_uncompress_points(torch.empty((8, 96), dtype=torch.uint8, device="meta")[:, ::2])
    for call in (lambda: V.g1_uncompress_points(meta), lambda: V.batch_points(meta)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    chain = torch.empty((2 * V.NUM_WINDOWS,) + tuple(points.shape), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        V.subgroup_check_from_bases(chain[0], chain[0::2], chain[1::2])
    with pytest.raises(ValueError, match="stride"):
        V.subgroup_check_from_bases(chain[0], chain[0::2], chain[1::2].contiguous())
    with pytest.raises(ValueError, match="lanes"):
        V.subgroup_check_from_bases(chain[0], chain[0::2], chain[1::2], lanes=(4, 4))
    assert all(v == 0 for v in _build.LAUNCHES.values())
