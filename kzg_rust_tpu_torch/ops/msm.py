"""Fixed-base multi-scalar multiplication (device path).

Counterpart of the JAX package's ``ops/msm.py``.  Two parts:

* The prover's GLV fixed-base MSM over the setup points.  Every scalar k
  splits as ``k = k1 + k2 lam (mod r)`` with ``|k1|, |k2| < 2^128``
  (:mod:`.glv`), ``phi(P) = (beta x, y) = [lam] P``, so a table of 26 signed
  base-32 windows of a 128-bit scalar serves both halves: the
  ``[26, 16, N, 2, 12]`` affine table of ``d 32^j P_i`` (d = 1..16) built by
  :meth:`MsmContext.build_from_points` as a launch sequence of the ported
  kernels (one K4 chain launch for the window bases, 15 K3 launches for the
  multiples, one batched Fp inversion, two K1 launches).  An MSM is then
  two launches: M1 (:func:`glv_digits_from_limbs`, ``csrc/msm_kernels.cu``
  ``kzg_glv_digits``: the device GLV split and signed base-32 recoding of
  every scalar) and M2 (:func:`msm_point`, ``kzg_msm_glv``: the
  digit-selected table entries mixed-added into ``accumulators`` sums, which
  the kernel itself reduces to the one point).
* The signed base-16 window select of verification's generator multiple
  (stage 2, ``verify_kernels.gen_mult``): a ``[64, 8, 1, 3, 12]`` table of
  the G1 generator.

On CPU tensors M1 and M2 run their plain versions (``*_plain``), which give
the same digits and the same point word for word; on CUDA tensors they
launch their kernels or raise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import curve as C
from . import glv
from . import limbs as L
from .limbs import FP, FR

WINDOW_BITS = 4
NUM_WINDOWS = 64  # ceil(255 / 4)
NUM_MULTIPLES = 8  # signed digits: |d| in 1..8

GLV_WINDOW_BITS = glv.WINDOW_BITS_32  # 5
GLV_NUM_WINDOWS = glv.NUM_WINDOWS_GLV32  # 26
GLV_NUM_MULTIPLES = 16  # signed base-32 digits: |d| in 1..16

# M2 on the card: one accumulator a thread, BLOCK_THREADS threads a block
# and ACCUMULATORS_PER_SM accumulators an SM, so that one wave covers every
# accumulator.  Chosen by chip_smoke.py phase 2's sweep on the H100
# (PERF.md).  On the CPU the plain version takes CPU_ACCUMULATORS in blocks
# of CPU_BLOCK.  KERNEL_BLOCKS are the block sizes kzg_msm_glv is built
# for, and MAX_BLOCKS its most blocks (the last block holds every block's
# sum in shared memory), both shared with csrc/msm_kernels.cu.
ACCUMULATORS_PER_SM = 384
BLOCK_THREADS = 384
KERNEL_BLOCKS = (128, 256, 384)
MAX_BLOCKS = 1024
CPU_ACCUMULATORS = 64
CPU_BLOCK = 16
# M1's lanes a scalar, the default first: 8 spreads a scalar over a lane
# group (32 scalars a block, so a blob's 4096 take 128 SMs); 1 is the
# one-thread design, kept for comparison.  chip_smoke.py phase 2
# times both on the H100 (PERF.md).
GLV_DIGIT_LANES = (8, 1)


# ---------------------------------------------------------------------------
# M1: the GLV split and signed base-32 recoding of canonical Fr scalars
# ---------------------------------------------------------------------------


def _halves_const(value: int, n: int, device) -> torch.Tensor:
    return torch.tensor([(value >> (16 * k)) & 0xFFFF for k in range(n)], dtype=torch.int64, device=device)


def _recode32_plain(mag: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """int64 half-words [M, k] of magnitudes below 2^130, signs [M] ->
    [26, M] signed base-32 digits (a digit above 16 borrows from the next
    window), the sign folded in."""
    mag = F.pad(mag[..., :10], (0, max(0, 10 - mag.shape[-1])))
    carry = torch.zeros(mag.shape[:-1], dtype=torch.int64, device=mag.device)
    digits = []
    for j in range(GLV_NUM_WINDOWS):
        h, off = divmod(GLV_WINDOW_BITS * j, 16)
        d = (((mag[..., h] | (mag[..., h + 1] << 16)) >> off) & 31) + carry
        carry = (d > 16).to(torch.int64)
        digits.append(d - 32 * carry)
    out = torch.stack(digits)
    return torch.where(neg[None], -out, out).to(torch.int8)


def glv_digits_plain(k: torch.Tensor) -> torch.Tensor:
    """Plain version of M1 on int64 half-words: canonical Fr words [M, 8] ->
    digits [2, 26, M] int8 (row 0 the k1 half, row 1 the k2 half).

    The JAX package's device split (``msm.glv_decompose_limbs``): m1 =
    floor(k G1C / 2^264), m2' = [k >= (r + 1) / 2], k1 = k - (m1 z^2 + m2'),
    k2 = m2' (z^2 - 1) - m1.  It is floor-based and differs from the host's
    Babai split (:func:`.glv.decompose`); both recombine to k."""
    dev = k.device
    h = L._halves(k)  # [M, 16]
    prod = L._norm(L._mul_cols(h, _halves_const(glv.G1C, 9, dev), 25))  # < 2^392
    # Shift by 264 = 16 half-words and 8 bits: m1 < 2^128, 8 half-words.
    m1 = (prod[..., 16:24] >> 8) | ((prod[..., 17:25] & 0xFF) << 8)
    m2 = L.cmp_plain(k, FR.const(glv.HALF_R_CEIL, dev), 1)
    u = L._mul_cols(m1, _halves_const(glv.Z2, 8, dev), 16)
    u[..., 0] += m2.to(torch.int64)
    d1, top1 = L._norm(h - L._norm(u), with_top=True)  # k - u mod 2^256
    neg1 = top1 < 0
    mag1 = torch.where(neg1[..., None], L._norm(-d1), d1)
    v = torch.where(m2[..., None], _halves_const(glv.Z2 - 1, 8, dev), 0)
    d2, top2 = L._norm(v - m1, with_top=True)
    neg2 = top2 < 0
    mag2 = torch.where(neg2[..., None], L._norm(-d2), d2)
    return torch.stack([_recode32_plain(mag1, neg1), _recode32_plain(mag2, neg2)])


def glv_digits_from_limbs(k: torch.Tensor, lanes: int = GLV_DIGIT_LANES[0]) -> torch.Tensor:
    """M1: canonical Fr words [M, 8] -> digits [2, 26, M] int8 in [-16, 16]
    with ``sum_j d[0, j] 32^j + lam sum_j d[1, j] 32^j == k (mod r)``, both
    halves below 2^128 in magnitude: the scalar recoding of the GLV MSM on
    the device (counterpart of the JAX ``glv_digits_from_limbs``, whose
    digits it equals).  ``lanes`` a scalar, one of
    :data:`GLV_DIGIT_LANES`, is the kernel's variant."""
    L._check(FR, k)
    if k.dim() != 2:
        raise ValueError(f"glv_digits: expected [M, 8] scalars, got {tuple(k.shape)}")
    if lanes not in GLV_DIGIT_LANES:
        raise ValueError(f"glv_digits: {lanes} lanes a scalar, not one of {GLV_DIGIT_LANES}")
    if k.device.type == "cpu":
        return glv_digits_plain(k)
    k = k.contiguous()
    m = k.shape[0]
    out = torch.empty((2, GLV_NUM_WINDOWS, m), dtype=torch.int8, device=k.device)
    if m:
        L._check_aligned("kzg_glv_digits", k, out)
        _build.launch("kzg_glv_digits", k.device, k, out, m, lanes)
    return out


def recode_glv_host(scalars) -> tuple[np.ndarray, np.ndarray]:
    """Canonical Fr ints -> (d1, d2) int8 [26, n] signed base-32 digit
    matrices (host-side Babai split + recode, for callers with int scalars)."""
    k1s, k2s = glv.decompose_batch(scalars)
    return glv.recode_base32_signed(k1s), glv.recode_base32_signed(k2s)


# ---------------------------------------------------------------------------
# M2: digit-selected mixed-add accumulation over the affine table
# ---------------------------------------------------------------------------


def _check_msm_operands(table, inf_mask, digits, accumulators, block):
    n = table.shape[2]
    if table.dtype != torch.int32 or table.shape != (GLV_NUM_WINDOWS, GLV_NUM_MULTIPLES, n, 2, FP.nwords):
        raise ValueError(f"msm: expected an int32 [26, 16, N, 2, 12] table, got {table.dtype} {tuple(table.shape)}")
    if inf_mask.dtype != torch.bool or inf_mask.shape != (n,):
        raise ValueError(f"msm: expected a bool [{n}] infinity mask, got {inf_mask.dtype} {tuple(inf_mask.shape)}")
    if digits.dtype != torch.int8 or digits.shape != (2, GLV_NUM_WINDOWS, n):
        raise ValueError(f"msm: expected int8 [2, 26, {n}] digits, got {digits.dtype} {tuple(digits.shape)}")
    if not 1 <= accumulators <= 2 * GLV_NUM_WINDOWS * n:
        raise ValueError(f"msm: {accumulators} accumulators outside [1, {2 * GLV_NUM_WINDOWS * n}]")
    if block < 1 or -(-accumulators // block) > MAX_BLOCKS:
        raise ValueError(f"msm: {accumulators} accumulators in blocks of {block}: more than {MAX_BLOCKS} blocks")
    if inf_mask.device != table.device or digits.device != table.device:
        raise ValueError("msm: operands on different devices")


def msm_accumulate_plain(table, inf_mask, digits, accumulators: int) -> torch.Tensor:
    """The accumulation of M2's plain version: accumulator a takes the
    selections s = a, a + accumulators, ... (s = (half * 26 + window) * N +
    point), skipping zero digits and infinity bases: the first one as it is,
    (x, y, 1), then each mixed-added in order; an accumulator that takes
    none is infinity.  Returns the ``[accumulators, 3, 12]`` sums."""
    w, m, n = table.shape[:3]
    dev = table.device
    total = 2 * w * n
    steps = -(-total // accumulators)
    pad = steps * accumulators - total
    d = F.pad(digits.reshape(-1).to(torch.int64), (0, pad))
    s = torch.arange(steps * accumulators, device=dev)
    point = s % n
    window = (s // n) % w
    phi = s // n >= w
    mag = d.abs()
    valid = (mag != 0) & ~inf_mask[point] & (s < total)
    entry = (window * m + (mag - 1).clamp(min=0)) * n + point
    flat = table.reshape(w * m * n, 2, FP.nwords)
    beta = FP.const(C.BETA_MONT, dev)
    one = FP.const("one_mont", dev)
    acc = torch.stack([torch.zeros_like(one), one, torch.zeros_like(one)]).expand(accumulators, 3, FP.nwords)
    started = torch.zeros(accumulators, dtype=torch.bool, device=dev)
    for k in range(steps):
        cols = slice(k * accumulators, (k + 1) * accumulators)
        if not valid[cols].any():
            continue
        e = flat[entry[cols]]
        x = torch.where(phi[cols, None], L.mont_mul_plain(FP, e[:, 0], beta), e[:, 0])
        y = torch.where((d[cols] < 0)[:, None], L.sub_mod_plain(FP, torch.zeros_like(one), e[:, 1]), e[:, 1])
        taken = torch.stack([x, y, one.expand_as(x)], dim=-2)
        if started.any():
            taken = torch.where(started[:, None, None], C.proj_add_mixed_plain(acc, taken[:, :2]), taken)
        acc = torch.where(valid[cols, None, None], taken, acc)
        started |= valid[cols]
    return acc.contiguous()


def block_sums_plain(acc, block: int) -> torch.Tensor:
    """``[A, 3, 12]`` accumulators -> ``[ceil(A / block), 3, 12]``: each
    block of ``block`` rows (the last one ragged) summed by the halving tree
    of :func:`curve.sum_points` with plain adds, as M2's blocks do."""
    a = acc.shape[0]
    full = a // block
    sums = []
    if full:
        rows = acc[: full * block].reshape(full, block, 3, FP.nwords).transpose(0, 1)
        sums.append(C.sum_points(rows, add=C.proj_add_plain))
    if a % block:
        sums.append(C.sum_points(acc[full * block :], add=C.proj_add_plain)[None])
    return torch.cat(sums)


def msm_point_plain(table, inf_mask, digits, accumulators: int, block: int) -> torch.Tensor:
    """Plain version of M2: the accumulation (:func:`msm_accumulate_plain`),
    each block's sum (:func:`block_sums_plain`), then the halving tree over
    the blocks' sums, all with plain adds in the kernel's grouping and order,
    so the projective point is the kernel's word for word."""
    acc = msm_accumulate_plain(table, inf_mask, digits, accumulators)
    return C.sum_points(block_sums_plain(acc, block), add=C.proj_add_plain)


def msm_point(table, inf_mask, digits, accumulators: int, block: int, ticket=None) -> torch.Tensor:
    """M2: the MSM of the selections of ``digits`` [2, 26, N] int8 over
    ``table`` [26, 16, N, 2, 12] (affine, Montgomery) and ``inf_mask`` [N]
    bool, as one projective Montgomery point [3, 12]: ``accumulators`` sums
    in blocks of ``block``, each block's sum, then the sum of those (see
    :func:`msm_point_plain`), in one launch of ``kzg_msm_glv`` on the card.

    On the card ``ticket`` is a zero int32 [1] on the table's device, by
    which the kernel's last block finds itself and which it sets back to 0
    (:class:`MsmContext` owns one): the launches that share a ticket must
    run in order, on one stream."""
    _check_msm_operands(table, inf_mask, digits, accumulators, block)
    if table.device.type == "cpu":
        return msm_point_plain(table, inf_mask, digits, accumulators, block)
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"msm: kzg_msm_glv takes blocks of {KERNEL_BLOCKS} threads, got {block}")
    if ticket is None or ticket.dtype != torch.int32 or ticket.numel() != 1 or ticket.device != table.device:
        raise ValueError("msm: the card's M2 needs a zero int32 [1] ticket on the table's device")
    dev = table.device
    partials = torch.empty((-(-accumulators // block), 3, FP.nwords), dtype=torch.int32, device=dev)
    out = torch.empty((3, FP.nwords), dtype=torch.int32, device=dev)
    _build.launch(
        "kzg_msm_glv",
        dev,
        table.contiguous(),
        inf_mask.contiguous(),
        digits.contiguous(),
        partials,
        ticket,
        out,
        table.shape[2],
        accumulators,
        block,
    )
    return out


def msm_config(n: int, device) -> tuple[int, int]:
    """M2's (accumulators, block) for an N-point table: on CUDA the card's
    SM count times ACCUMULATORS_PER_SM in blocks of BLOCK_THREADS;
    CPU_ACCUMULATORS in blocks of CPU_BLOCK on the CPU; at most the 52 N
    selections."""
    device = torch.device(device)
    if device.type == "cuda":
        accs = torch.cuda.get_device_properties(device).multi_processor_count * ACCUMULATORS_PER_SM
        block = BLOCK_THREADS
    else:
        accs, block = CPU_ACCUMULATORS, CPU_BLOCK
    return max(1, min(2 * GLV_NUM_WINDOWS * n, accs)), block


# ---------------------------------------------------------------------------
# The GLV affine window table
# ---------------------------------------------------------------------------


def build_glv_table(points: torch.Tensor):
    """[N, 3, 12] projective Montgomery points -> (table [26, 16, N, 2, 12]
    affine Montgomery (X, Y) of ``d 32^j P_i``, inf_mask [N] bool).

    The window bases 32^j P are rows 0, 5, ..., 125 of the doubling chain
    (P, then one K4 chain launch of 125 steps), the multiples d B (d = 1..16)
    15 K3 launches at 26 N points, then one batched Fp inversion of every Z
    and two K1 launches to affine.  Infinity bases give Z = 0, which would
    zero every output of the batched inversion, so they are replaced by
    mont(1) first (their rows are garbage, masked by ``inf_mask`` at use);
    multiples of a point of the prime-order subgroup are never infinity."""
    n = points.shape[0]
    dev = points.device
    steps = (GLV_NUM_WINDOWS - 1) * GLV_WINDOW_BITS
    chain = torch.empty((steps + 1,) + tuple(points.shape), dtype=torch.int32, device=dev)
    chain[0] = points
    C.proj_double_chain(chain[0], steps, out=chain[1:])
    flat = chain[::GLV_WINDOW_BITS].reshape(GLV_NUM_WINDOWS * n, 3, FP.nwords)
    del chain
    mults = torch.empty((GLV_NUM_MULTIPLES,) + tuple(flat.shape), dtype=torch.int32, device=dev)
    mults[0] = flat
    for d in range(1, GLV_NUM_MULTIPLES):
        C.proj_add(mults[d - 1], flat, out=mults[d])
    proj = mults.reshape(GLV_NUM_MULTIPLES, GLV_NUM_WINDOWS, n, 3, FP.nwords).transpose(0, 1)
    z = proj[..., 2, :]
    z_safe = torch.where(L.is_zero(z)[..., None], FP.const("one_mont", dev), z)
    zinv = L.batch_mont_inv(FP, z_safe.reshape(-1, FP.nwords)).reshape(z.shape)
    x = L.mont_mul(FP, proj[..., 0, :], zinv)
    y = L.mont_mul(FP, proj[..., 1, :], zinv)
    return torch.stack([x, y], dim=-2), C.point_is_inf(points)


class MsmContext:
    """Per-settings device state: the GLV affine window table, the mask of
    infinity bases, M2's configuration (:func:`msm_config`) and, on a card,
    M2's ticket."""

    def __init__(self, n: int, table, inf_mask, config: tuple[int, int]):
        self.n = n
        self.table = table
        self.inf_mask = inf_mask
        self.accumulators, self.block = config
        self.ticket = torch.zeros(1, dtype=torch.int32, device=table.device) if table.device.type == "cuda" else None

    @classmethod
    def build(cls, settings, device) -> "MsmContext":
        return cls.build_from_points(settings.g1_values, device)

    @classmethod
    def build_from_points(cls, points_affine, device) -> "MsmContext":
        n = len(points_affine)
        table, inf_mask = build_glv_table(C.points_to_proj(points_affine, device))
        return cls(n, table, inf_mask, msm_config(n, device))

    def point(self, digits) -> torch.Tensor:
        """M2 over this table: digits [2, 26, N] -> the MSM [3, 12]."""
        return msm_point(self.table, self.inf_mask, digits, self.accumulators, self.block, self.ticket)


def msm_fixed_base(ctx: MsmContext, scalars):
    """MSM over the fixed setup points (canonical Fr ints); returns a golden
    affine point or None, the same as ``g1_lincomb_naive`` (reference:
    utils.rs:367-410).  Host recoding, then M2."""
    d1, d2 = recode_glv_host(scalars)
    digits = torch.from_numpy(np.stack([d1, d2])).to(ctx.table.device)
    return C.proj_to_points(ctx.point(digits)[None].cpu())[0]


# ---------------------------------------------------------------------------
# Signed base-16 window select (the generator table of verification)
# ---------------------------------------------------------------------------


def recode_signed_digits(scalars, n: int) -> np.ndarray:
    """List of ints (mod r) -> [64, n] int8 signed base-16 digits.

    Standard signed-window recoding: nibble + carry, values > 8 borrow from
    the next window.  Scalars are < r < 2^255, so the top nibble is <= 7 and
    the final carry is absorbed (top digit <= 8), never emitted.
    """
    buf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    by = np.frombuffer(buf, dtype=np.uint8).reshape(n, 32)
    return recode_signed_digits_le_bytes(by)


def recode_signed_digits_le_bytes(by: np.ndarray) -> np.ndarray:
    """[n, 32] little-endian scalar bytes -> [64, n] int8 signed digits.
    Byte-matrix entry point so bulk callers skip the python-int round trip."""
    n = by.shape[0]
    nib = np.zeros((n, NUM_WINDOWS), dtype=np.int16)
    nib[:, 0::2] = by & 0xF
    nib[:, 1::2] = by >> 4
    digits = np.zeros((n, NUM_WINDOWS), dtype=np.int8)
    carry = np.zeros(n, dtype=np.int16)
    for j in range(NUM_WINDOWS):
        d = nib[:, j] + carry
        over = (d > 8).astype(np.int16)
        carry = over
        digits[:, j] = (d - 16 * over).astype(np.int8)
    assert not carry.any(), "scalar exceeded 255 bits"
    return np.ascontiguousarray(digits.T)  # [64, n]


def select_window_points(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Gather the digit-selected multiple per (window, point) from a
    ``[W, 8, N, 3, 12]`` table: digit 0 -> projective infinity (0, Y, 0 -
    both X and Z must be zeroed for the complete-add formulas; table Y is
    never zero), negative digit -> negated Y.  Returns [W, N, 3, 12]."""
    digits = digits.to(device=table.device, dtype=torch.int64)
    mag = digits.abs()  # [W, N]
    w, _, n = table.shape[:3]
    idx = (mag - 1).clamp(min=0)[:, None, :, None, None].expand(w, 1, n, 3, FP.nwords)
    sel = torch.gather(table, 1, idx)[:, 0]
    zmask = (mag == 0)[..., None]
    x = torch.where(zmask, 0, sel[..., 0, :])
    z = torch.where(zmask, 0, sel[..., 2, :])
    y = torch.where((digits < 0)[..., None], L.neg_mod(FP, sel[..., 1, :]), sel[..., 1, :])
    return torch.stack([x, y, z], dim=-2)
