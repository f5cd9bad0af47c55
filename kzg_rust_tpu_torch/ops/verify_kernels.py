"""Batched device stages of ``verify_blob_kzg_proof_batch`` (device path).

Counterpart of the JAX package's ``ops/verify_kernels.py``, as three stages
of kernel launches on one stream (CUDA launches are asynchronous, so the
host's Fiat-Shamir hashing overlaps stage 1):

* stage 1, :func:`batch_points`: three launches, G1 decompression with its
  Fp square root (kernel A), the 131-step window-base doubling chain (one
  K4 chain launch) and the GLV subgroup check with the stage's flags
  (kernel B), A and B in ``csrc/stage1_kernels.cu``;
* :func:`bary_batch_from_bytes`: blob ingest and canonicality (one launch of
  ``kzg_fr_ingest``) and the batched barycentric evaluation;
* stage 2, :func:`batch_stage2`: the RLC combination as one wide select
  and tree sum over the stage-1 bases, minus one generator multiple.

Elsewhere every Fp and Fr product is K1/K2 and every point add and double
is K3/K4 (see :mod:`.limbs` and :mod:`.curve`); selects and stacks are
plain tensor ops.  On CPU tensors the same code runs the plain versions
(``*_plain``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.field import P as _P
from . import _build
from . import curve as C
from . import glv
from . import limbs as L
from . import msm as M
from .limbs import FP, FR

NUM_WINDOWS = glv.NUM_WINDOWS_GLV  # 66 base-4 windows per 128-bit GLV half

# Signed base-4 digits of z^2 (the subgroup-check scalar), a host constant.
_Z2_DIGITS = glv.recode_base4_signed([glv.Z2])[:, 0]  # [66] int8
# Curve constant b = 4 in Montgomery form (for x^3 + 4 during decompression).
_B4_MONT = 4 * FP.mont_r % _P
# (p+1)/2: y is "lexicographically largest" iff y >= (p+1)/2.
_HALF_P1 = (_P + 1) // 2
# The square root rhs^((p+1)/4): its chain (sliding 5-bit windows over the
# odd powers, 375 squarings and 82 products), which kernel A takes as a
# parameter and its plain version follows.
SQRT_CHAIN = L.pow_chain((_P + 1) // 4, 5)
_SQRT_CODE = SQRT_CHAIN.to_bytes()
DECOMPRESS_LANES = (4, 2, 1)  # kernel A's lanes a point, most first


def decompress_lanes(n: int, sms: int) -> int:
    """Kernel A's lanes a point for ``n`` points on ``sms`` SMs: 4 while
    that keeps at most one warp on each of the SMs' four sub-partitions,
    else 2.  The chain is latency-bound there, so more lanes (a shorter
    product) win; past it the warps queue on the integer pipes (on the
    H100: 4 lanes 0.241 ms from 128 to 2,048 points, at 8,192 points, the
    widest a stage-1 dispatch gives, 2 lanes 0.336 ms against 4 lanes'
    0.373).  One lane a point is the one-thread design, for comparison."""
    return 4 if n * 4 <= 4 * 32 * sms else 2


# Kernel B's variants, (lanes an add, lane groups a point), most lanes a
# point first: the level-parallel tree, then (4, 1), the serial tree (one
# group a point), kept for comparison.
SUBGROUP_LANES = ((8, 8), (8, 4), (8, 2), (2, 2), (4, 1))


def subgroup_lanes(n: int, sms: int) -> tuple[int, int]:
    """Kernel B's variant, (lanes an add, lane groups a point), for ``n``
    points on ``sms`` SMs; a level's adds run side by side, one a group.
    While the card is mostly idle a point's wait decides: 8 groups of 8
    lanes (64 lanes a point, 5 levels of two products) up to 2 points an
    SM, then 4 groups (up to 8 points an SM) and 2 (up to 16).  Past that
    the card is full and the work each point runs decides: 8 lanes an add
    leave two idle and each forms a second-level operand, and the narrowing
    levels idle whole groups, so 2 groups of 2 lanes (4 lanes a point).
    The cuts are the H100's sweep (132 SMs, PERF.md §6: 8 x 8 fastest at
    128 and 256 points, 8 x 4 at 512 and 1,024, 8 x 2 at 2,048, 2 x 2 at
    4,096 and 8,192)."""
    for lanes, points_an_sm in (((8, 8), 2), ((8, 4), 8), ((8, 2), 16)):
        if n <= points_an_sm * sms:
            return lanes
    return (2, 2)


# ---------------------------------------------------------------------------
# G1 decompression
# ---------------------------------------------------------------------------


def g1_uncompress_points_plain(comp: torch.Tensor):
    """Plain version of kernel A (``kzg_g1_decompress``), any device: [N, 48]
    uint8 ZCash-compressed G1 -> ([N, 3, 12] Montgomery projective points,
    ok [N] bool).  The golden ``g1_uncompress`` rules: compression bit
    required, canonical x < p, on-curve (the square root must exist), strict
    infinity encoding (0xc0 then zeros), sign = y > (p-1)/2.  Invalid rows
    yield ok=False (their points are unspecified, but the kernel gives the
    same words)."""
    dev = comp.device
    mul = lambda u, v: L.mont_mul_plain(FP, u, v)  # noqa: E731
    flags = comp[:, 0].to(torch.int32)
    comp_bit = (flags & 0x80) != 0
    inf_bit = (flags & 0x40) != 0
    sign_bit = (flags & 0x20) != 0
    first = (flags & 0x1F).to(torch.uint8)
    x = L.bytes_be_to_words(torch.cat([first[:, None], comp[:, 1:]], dim=1))
    x_ok = ~L.cmp_plain(x, FP.const("mod", dev), 1)
    # Clamp out-of-range x to 0 so the Montgomery ops stay in range (the row
    # is already marked invalid; its point is never trusted).
    x = torch.where(x_ok[:, None], x, 0)
    xm = mul(x, FP.const("r2", dev))
    rhs = L.add_mod_plain(FP, mul(xm, mul(xm, xm)), FP.const(_B4_MONT, dev))
    ym = L.mont_pow_chain_plain(FP, rhs, SQRT_CHAIN)
    on_curve = L.cmp_plain(mul(ym, ym), rhs, 0)
    y_large = L.cmp_plain(mul(ym, FP.const("one", dev)), FP.const(_HALF_P1, dev), 1)
    ym = torch.where((y_large != sign_bit)[:, None], L.sub_mod_plain(FP, FP.const("zero", dev), ym), ym)

    inf_enc_ok = inf_bit & ~sign_bit & (first == 0) & (comp[:, 1:] == 0).all(dim=1)
    ok = comp_bit & torch.where(inf_bit, inf_enc_ok, x_ok & on_curve)

    one_m = FP.const("one_mont", dev).expand_as(xm)
    inf = inf_bit[:, None]
    xo = torch.where(inf, 0, xm)
    yo = torch.where(inf, one_m, ym)
    zo = torch.where(inf, 0, one_m)
    return torch.stack([xo, yo, zo], dim=-2), ok


def _check_compressed(comp: torch.Tensor) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.shape[1] != 48:
        raise ValueError(f"expected uint8 [N, 48] compressed points, got {comp.dtype} {tuple(comp.shape)}")


def _decompress(comp: torch.Tensor, out: torch.Tensor, flags=None, lanes: int | None = None) -> torch.Tensor:
    """Kernel A: decompress ``comp`` into ``out`` [N, 3, 12] (contiguous);
    returns ok [N] uint8.  ``flags`` [2] int32, when given, is set to 1
    (kernel B clears it).  ``lanes``, 1, 2 or 4 a point, is the kernel's
    variant (by default :func:`decompress_lanes`); the square root runs
    :data:`SQRT_CHAIN`, which the kernel checks makes (p+1)/4."""
    n = comp.shape[0]
    if lanes is None:
        lanes = decompress_lanes(n, L._sm_count(comp.device)) if comp.device.type == "cuda" else DECOMPRESS_LANES[0]
    if not comp.is_contiguous() or not out.is_contiguous():
        raise ValueError("kzg_g1_decompress: the compressed rows and the points must be contiguous")
    L._check_aligned("kzg_g1_decompress", comp, out)
    ok = torch.empty(n, dtype=torch.uint8, device=comp.device)
    _build.launch("kzg_g1_decompress", comp.device, comp, out, ok, flags, n, lanes, _SQRT_CODE, len(_SQRT_CODE))
    return ok


def g1_uncompress_points(comp: torch.Tensor, lanes: int | None = None):
    """[N, 48] uint8 ZCash-compressed G1 -> ([N, 3, 12] Montgomery
    projective points, ok [N] bool), by :func:`g1_uncompress_points_plain`'s
    rules.  On a CUDA tensor one launch of kernel A (``kzg_g1_decompress``,
    ``csrc/stage1_kernels.cu``; ``lanes`` picks its variant),
    on a CPU tensor the plain version."""
    _check_compressed(comp)
    if comp.device.type == "cpu":
        return g1_uncompress_points_plain(comp)
    points = torch.empty((comp.shape[0], 3, FP.nwords), dtype=torch.int32, device=comp.device)
    return points, _decompress(comp, points, lanes=lanes).view(torch.bool)


# ---------------------------------------------------------------------------
# Shared window-base chain + GLV subgroup check
# ---------------------------------------------------------------------------


def bases_chain(points: torch.Tensor):
    """[N, 3, 12] -> (bases [W, N, 3, 12], bases2 [W, N, 3, 12]) with
    bases[j] = 4^j P and bases2[j] = 2 * 4^j P: the 2W - 1 doublings as one
    K4 chain launch into ``chain`` [2W, N, 3, 12] (chain[k] = 2^k P), whose
    even and odd rows are the two tables (views; each row contiguous)."""
    chain = torch.empty((2 * NUM_WINDOWS,) + points.shape, dtype=torch.int32, device=points.device)
    chain[0] = points
    C.proj_double_chain(chain[0], 2 * NUM_WINDOWS - 1, out=chain[1:])
    return chain[0::2], chain[1::2]


def subgroup_check_from_bases_plain(points, bases, bases2):
    """Plain version of kernel B (``kzg_g1_subgroup_check``), any device:
    GLV subgroup membership phi(P) == -[z^2]P for every point, with [z^2]P
    assembled from the shared window bases via the constant signed base-4
    digits of z^2 (17 of 66 windows nonzero, so the selection is static) as
    the halving tree of :func:`.curve.sum_points`.  Infinity passes.
    Returns bool [N]."""
    mul = lambda u, v: L.mont_mul_plain(FP, u, v)  # noqa: E731
    zero = FP.const("zero", points.device)
    parts = []
    for j, d in enumerate(_Z2_DIGITS.tolist()):
        if d == 0:
            continue
        p = (bases2 if abs(d) == 2 else bases)[j]
        if d < 0:
            p = torch.stack([p[..., 0, :], L.sub_mod_plain(FP, zero, p[..., 1, :]), p[..., 2, :]], dim=-2)
        parts.append(p)
    z2p = C.sum_points(torch.stack(parts), add=C.proj_add_plain)  # [N, 3, 12] = [z^2] P
    phix = mul(points[..., 0, :], FP.const(C.BETA_MONT, points.device))
    phiy = points[..., 1, :]
    phiz = points[..., 2, :]
    x2, y2, z2 = z2p[..., 0, :], L.sub_mod_plain(FP, zero, z2p[..., 1, :]), z2p[..., 2, :]
    eq_x = L.cmp_plain(mul(phix, z2), mul(x2, phiz), 0)
    eq_y = L.cmp_plain(mul(phiy, z2), mul(y2, phiz), 0)
    inf_a = L.cmp_plain(phiz, zero, 0)
    inf_b = L.cmp_plain(z2, zero, 0)
    return (eq_x & eq_y & ~inf_a & ~inf_b) | (inf_a & inf_b)


def _check_bases(points, bases, bases2) -> None:
    C._check_points(points)
    if points.dim() != 3:
        raise ValueError(f"expected [N, 3, {FP.nwords}] points, got {tuple(points.shape)}")
    shape = (NUM_WINDOWS,) + tuple(points.shape)
    for t in (bases, bases2):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != points.device:
            raise ValueError(f"expected int32 {shape} window bases on {points.device}, got {t.dtype} {tuple(t.shape)}")


def _subgroup(points, bases, bases2, dec_ok=None, flags=None, lanes: tuple[int, int] | None = None) -> torch.Tensor:
    """Kernel B over ``points`` and its window bases; returns sub_ok [N]
    uint8.  With ``flags`` [2] int32 (set to 1 by kernel A), flag 1 is
    cleared where a row fails and, with ``dec_ok`` (A's ok), flag 0 where a
    row does not decode.  ``lanes``, one of :data:`SUBGROUP_LANES` (lanes
    an add, groups a point), is the kernel's variant (by default
    :func:`subgroup_lanes`)."""
    n = points.shape[0]
    if lanes is None:
        lanes = subgroup_lanes(n, L._sm_count(points.device)) if points.device.type == "cuda" else SUBGROUP_LANES[0]
    if lanes not in SUBGROUP_LANES:
        raise ValueError(f"kzg_g1_subgroup_check: lanes {lanes}, not one of {SUBGROUP_LANES}")
    row = (n * 3 * FP.nwords, 3 * FP.nwords, FP.nwords, 1)
    if not points.is_contiguous() or bases.stride() != bases2.stride() or bases.stride()[1:] != row[1:]:
        raise ValueError("kzg_g1_subgroup_check: points contiguous, window rows contiguous and alike in stride")
    if bases.stride(0) % 4:
        raise ValueError(f"kzg_g1_subgroup_check: window rows {bases.stride(0)} words apart, not a multiple of 4")
    L._check_aligned("kzg_g1_subgroup_check", points, bases, bases2)
    sub_ok = torch.empty(n, dtype=torch.uint8, device=points.device)
    _build.launch(
        "kzg_g1_subgroup_check", points.device, points, bases, bases2, bases.stride(0), dec_ok, sub_ok, flags, n, *lanes
    )
    return sub_ok


def subgroup_check_from_bases(points, bases, bases2, lanes: tuple[int, int] | None = None):
    """GLV subgroup membership of every point (bool [N]), by
    :func:`subgroup_check_from_bases_plain`'s rules and order.  On a CUDA
    tensor one launch of kernel B (``kzg_g1_subgroup_check``,
    ``csrc/stage1_kernels.cu``; ``lanes`` picks its variant), on a CPU
    tensor the plain version."""
    _check_bases(points, bases, bases2)
    if points.device.type == "cpu":
        return subgroup_check_from_bases_plain(points, bases, bases2)
    return _subgroup(points, bases, bases2, lanes=lanes).view(torch.bool)


def batch_points_plain(comp_bytes: torch.Tensor):
    """Plain version of stage 1 (:func:`batch_points`), any device."""
    points, dec_ok = g1_uncompress_points_plain(comp_bytes)
    chain = torch.empty((2 * NUM_WINDOWS,) + points.shape, dtype=torch.int32, device=points.device)
    chain[0] = points
    chain[1:] = C.proj_double_chain_plain(points, 2 * NUM_WINDOWS - 1)
    bases, bases2 = chain[0::2], chain[1::2]
    sub_ok = subgroup_check_from_bases_plain(points, bases, bases2)
    flags = torch.stack([dec_ok.all(), sub_ok.all()]).to(torch.int32)
    return bases, bases2, flags


def batch_points(comp_bytes: torch.Tensor, lanes: tuple[int, int] | None = None):
    """Stage 1.  comp_bytes [2B, 48] uint8, blob-major (row 2b = commitment
    b, row 2b+1 = proof b, matching the stage-2 lane layout; padded rows
    encode infinity) -> (bases, bases2, flags): ``bases``/``bases2``
    [W, 2B, 3, 12] stay on the device as stage-2 inputs; ``flags`` [2]
    int32 (flag 0: all points decode, flag 1: all in the subgroup).

    On a CUDA tensor three launches with only allocations between them:
    kernel A decompresses into row 0 of the chain tensor, the K4 chain
    doubles it into the other 131 rows, kernel B (its variant ``lanes``,
    by default :func:`subgroup_lanes`) checks the subgroup and writes both
    flags.  On a CPU tensor the plain versions."""
    _check_compressed(comp_bytes)
    if comp_bytes.device.type == "cpu":
        return batch_points_plain(comp_bytes)
    n = comp_bytes.shape[0]
    chain = torch.empty((2 * NUM_WINDOWS, n, 3, FP.nwords), dtype=torch.int32, device=comp_bytes.device)
    flags = torch.empty(2, dtype=torch.int32, device=comp_bytes.device)
    dec_ok = _decompress(comp_bytes, chain[0], flags)
    C.proj_double_chain(chain[0], 2 * NUM_WINDOWS - 1, out=chain[1:])
    bases, bases2 = chain[0::2], chain[1::2]
    _subgroup(chain[0], bases, bases2, dec_ok, flags, lanes)
    return bases, bases2, flags


# ---------------------------------------------------------------------------
# Stage 2: the RLC combination as one wide select and tree sum
# ---------------------------------------------------------------------------


def stage2_digits(n: int, r_powers, r_times_z) -> np.ndarray:
    """Host recoding of all stage-2 scalars into the [W, 6n] int8 digit
    matrix (GLV split + signed base-4), blob-major: each blob owns six
    consecutive lanes [proof*k1, proof*k2, comm*k1, comm*k2, proofz*k1,
    proofz*k2] (k2 = the GLV/phi half).  Lanes 0-1 of each blob form the
    LHS group (sum r^i proof_i), lanes 2-5 the RHS group."""
    k1s, k2s = glv.decompose_batch(r_powers)
    q1s, q2s = glv.decompose_batch(r_times_z)
    # Recode only the 4n unique scalars (the proof and commitment lanes
    # share r^i's halves), then expand to the 6-lane layout with one take.
    uniq = []
    for i in range(n):
        uniq += [k1s[i], k2s[i], q1s[i], q2s[i]]
    rec = glv.recode_base4_signed(uniq)  # [W, 4n]
    base = 4 * np.arange(n)[:, None]
    idx = (base + np.array([0, 1, 0, 1, 2, 3])[None, :]).reshape(-1)
    return np.ascontiguousarray(rec[:, idx])


def _select_digit_multiple(table, choice, digits):
    """Pick ``d * 4^j * P`` for signed digits d in {-2..2}: ``table``
    [W, n, k, 3, 12] holds each blob's candidate multiples, ``choice``
    [W, n, L] the entry each lane takes for |d| (its B or its 2B); |d| = 0
    -> infinity (X=Z=0), d < 0 -> negated Y.  One gather makes the
    [W, n, L, 3, 12] result; the zeroing and the negation then write into
    it, so no lane-wide copy of the tables is made."""
    idx = choice[..., None, None].expand(tuple(choice.shape) + tuple(table.shape[-2:]))
    sel = torch.gather(table, 2, idx)
    zero = (digits == 0)[..., None]
    sel[..., 0, :].masked_fill_(zero, 0)
    sel[..., 2, :].masked_fill_(zero, 0)
    y = sel[..., 1, :]
    y.copy_(torch.where((digits < 0)[..., None], L.neg_mod(FP, y), y))
    return sel


def stage2_partials(bases, bases2, digits):
    """Select the digit multiples from the bases and tree-sum each lane
    group.  digits [W, 6n] blob-major (see :func:`stage2_digits`).  Returns
    [2, 3, 12]: row 0 = sum r^i proof_i, row 1 = sum r^i C_i +
    sum (r^i z_i) proof_i (the generator part not yet subtracted)."""
    n = digits.shape[1] // 6
    w = bases.shape[0]
    d = digits.to(torch.int32).reshape(w, n, 6)
    # Each blob's four candidates, C, 2C, P, 2P (row 2b of the bases is
    # commitment b, row 2b + 1 proof b); its six lanes take P, P, C, C, P,
    # P (entries 2, 2, 0, 0, 2, 2), plus one where |d| = 2.
    table = torch.stack([bases[:, 0::2], bases2[:, 0::2], bases[:, 1::2], bases2[:, 1::2]], dim=2)
    lane_src = 2 * (torch.arange(6, device=d.device) // 2 != 1)
    sel = _select_digit_multiple(table, lane_src + (d.abs() == 2), d)
    del table
    # The GLV halves multiply phi(P) = (beta X, Y, Z); phi commutes with
    # doubling and negation, so twisting the selected multiple is exact.
    # Only the odd lanes (the k2 halves) pay the beta product.
    beta = FP.const(C.BETA_MONT, bases.device)
    sel[:, :, 1::2, 0, :] = L.mont_mul(FP, sel[:, :, 1::2, 0, :], beta)
    lhs = C.sum_points(sel[:, :, :2].reshape(w * n * 2, 3, FP.nwords))
    rhs = C.sum_points(sel[:, :, 2:].reshape(w * n * 4, 3, FP.nwords))
    return torch.stack([lhs, rhs])


def gen_mult(gen_table, digits):
    """[s] G through the generator window table: one fixed-base multiply
    (replaces the reference's n per-blob generator multiplies).  digits
    [64, 1] signed base-16 (``msm.recode_signed_digits``)."""
    syg = M.select_window_points(gen_table, digits)  # [64, 1, 3, 12]
    return C.sum_points(syg)[0]  # [3, 12]


def batch_stage2(bases, bases2, digits, gen_table, sy_digits):
    """Stage 2, the whole RLC combination.  Returns [2, 3, 12]: row 0 =
    sum r^i proof_i, row 1 = sum r^i C_i + sum (r^i z_i) proof_i -
    [sum r^i y_i] G."""
    out = stage2_partials(bases, bases2, digits)
    rhs = C.proj_add(out[1], C.point_neg(gen_mult(gen_table, sy_digits)))
    return torch.stack([out[0], rhs])


def build_generator_table(device) -> torch.Tensor:
    """[64, 8, 1, 3, 12] window table d * 16^j * G (d = 1..8), built once on
    the host from the golden curve (affine, so Z = mont(1)) and uploaded."""
    from ..golden import curve as gc

    pts = []
    base = gc.G1_GENERATOR
    for _ in range(M.NUM_WINDOWS):
        mult = base
        for d in range(M.NUM_MULTIPLES):
            pts.append(mult)
            if d + 1 < M.NUM_MULTIPLES:
                mult = gc.g1_add(mult, base)
        for _ in range(M.WINDOW_BITS):
            base = gc.g1_double(base)
    table = C.points_to_proj(pts, device)
    return table.reshape(M.NUM_WINDOWS, M.NUM_MULTIPLES, 1, 3, FP.nwords)


# ---------------------------------------------------------------------------
# Batched barycentric evaluation
# ---------------------------------------------------------------------------


def bary_batch_from_bytes(ctx, blob_bytes: torch.Tensor, xs: torch.Tensor, tickets=None, flag=None):
    """Ingest + canonicality + batched barycentric evaluation:
    blob_bytes [B, n, 32] uint8 BE, xs [B, 8] canonical -> (ys [B, 8]
    canonical, ok bool scalar).  ``ok`` is False iff any field element is
    >= r; the ys are garbage in that case and callers must raise.
    ``tickets`` go to the domain sum (:func:`limbs.sum_mod`), ``flag`` to
    the ingest (:func:`limbs.ingest_check`, one launch on the card).

    The evaluations are laid out domain-major, [n, B, 8], so that the
    product tree of the batch inversion and the domain sum run over
    contiguous halves and rows of axis 0."""
    evals, ok = L.ingest_check(blob_bytes, flag)  # [n, B, 8]
    return bary_batch_inv(ctx, evals, xs, tickets)[0], ok


def bary_batch(ctx, evals: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """evals [n, B, 8] canonical, xs [B, 8] canonical -> ys [B, 8]
    canonical: y = (x^n - 1)/n * sum_i e_i w_i / (x - w_i).  Callers
    guarantee every x is out of the domain."""
    return bary_batch_inv(ctx, evals, xs)[0]


def bary_batch_inv(ctx, evals: torch.Tensor, xs: torch.Tensor, tickets=None):
    """:func:`bary_batch`, also returning the inverses it made: (ys [B, 8]
    canonical, inv [n, B, 8] = mont(1 / (x - w_i))), which the prover's
    out-of-domain quotient reuses.

    Form bookkeeping as in the JAX package: the evaluations stay canonical
    (``roots_m2`` carries w R^2, so the two term products land on
    (e w / (x - w)) R), and the domain sum, a plain modular sum of
    Montgomery terms here, drops to canonical form with one ``from_mont``
    on [B] (the JAX package's ``sum_mont_redc`` did both in one REDC)."""
    x_m = L.to_mont(FR, xs)  # [B, 8]
    s, inv = bary_partial(ctx, evals, x_m, tickets)
    return bary_finish(ctx, s, x_m), inv


def bary_partial(ctx, evals: torch.Tensor, x_m: torch.Tensor, tickets=None):
    """The barycentric sum over ``ctx``'s roots (the domain, or a shard's
    slice of it): evals [k, B, 8] canonical, x_m [B, 8] Montgomery -> (sum_i
    e_i w_i / (x - w_i) [B, 8] canonical, inv [k, B, 8])."""
    mul = lambda u, v: L.mont_mul(FR, u, v)  # noqa: E731
    d = L.sub_mod(FR, x_m[None], ctx.roots_m[:, None])  # [k, B, 8]
    inv = L.batch_mont_inv(FR, d, axis=0)
    terms = mul(mul(inv, ctx.roots_m2[:, None]), evals)  # Montgomery form
    return L.from_mont(FR, L.sum_mod(FR, terms, tickets)), inv  # canonical sum


def bary_finish(ctx, s: torch.Tensor, x_m: torch.Tensor) -> torch.Tensor:
    """(x^n - 1) / n times the barycentric sum ``s`` (canonical) -> y
    canonical."""
    s = L.mont_mul(FR, s, ctx.inv_n_m)  # canonical x mont -> canonical
    xn = L.mont_pow_const(FR, x_m, ctx.n)
    return L.mont_mul(FR, s, L.sub_mod(FR, xn, FR.const("one_mont", x_m.device)))
