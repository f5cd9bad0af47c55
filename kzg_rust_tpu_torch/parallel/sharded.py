"""Multi-device scale-out on one host: the point, domain and blob axes split
over a mesh of cards.

Counterpart of the JAX package's ``parallel/sharded.py``, whose
``shard_map`` programs become loops over the mesh here:

* a **mesh** is an ordered list of ``torch.device`` (:func:`default_mesh`,
  :func:`domain_mesh`, :func:`blobs_mesh`); ``["cpu"] * D`` runs every
  shard's plain versions, which is how the CPU tests drive it;
* each **shard** runs the port's single-device functions on its slice of
  the axis, under ``torch.cuda.device(d)``.  The shards are launched from
  one host thread in turn; launches do not wait for the card, so the cards
  work side by side;
* the **combine** is the in-process counterpart of the JAX programs'
  ``all_gather`` and replicated tail: the partials are copied to the mesh's
  first device, points summed there with the K3 tree
  (:func:`..ops.curve.sum_points`), Fr values with the Fr add, and flags
  AND-combined (``amin``).

Point addition is associative, so every result is the single-device
group element; its projective words differ with the order of the adds,
so callers and tests compare affine points (or canonical integers).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build
from ..ops import curve as C
from ..ops import limbs as L
from ..ops import msm as M
from ..ops import prover_kernels as PR
from ..ops import protocol_kernels as PK
from ..ops import verify_kernels as V
from ..ops.limbs import FR


def _mesh(n_devices: int | None = None, first=None) -> list[torch.device]:
    """``n_devices`` of the visible CUDA devices (all by default), in order
    from ``first`` (cuda:0 by default), wrapping around."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} CUDA devices, {count} visible; a list such as ['cpu'] * 2 runs the plain versions")
    start = 0 if first is None else (torch.device(first).index or 0)
    return [torch.device("cuda", (start + i) % count) for i in range(n)]


def default_mesh(n_devices: int | None = None, first=None) -> list[torch.device]:
    """A mesh over the setup's point axis (the prover's MSM and commit)."""
    return _mesh(n_devices, first)


def domain_mesh(n_devices: int | None = None, first=None) -> list[torch.device]:
    """A mesh over the evaluation domain's axis (one blob's barycentric
    evaluation; the reference's 4096-element loop, kzg.rs:353-378)."""
    return _mesh(n_devices, first)


def blobs_mesh(n_devices: int | None = None, first=None) -> list[torch.device]:
    """A mesh over the blob axis of batch verification (the reference's
    per-blob loop, kzg.rs:671-683)."""
    return _mesh(n_devices, first)


def _devices(mesh) -> list[torch.device]:
    return [torch.device(d) for d in mesh]


def _shard(total: int, mesh, what: str) -> int:
    """Rows a shard: ``total`` split evenly over the mesh, or ValueError."""
    if total % len(mesh):
        raise ValueError(f"{total} {what} not divisible by the mesh's {len(mesh)} devices")
    return total // len(mesh)


def _rows(t: torch.Tensor, lo: int, hi: int, device) -> torch.Tensor:
    """Rows lo..hi-1 of ``t`` on ``device``; rows past its end are zeros
    (a padded batch's infinity rows and zero blobs are made on the card)."""
    have = max(0, min(hi, t.shape[0]) - lo)
    if have == hi - lo:
        return t[lo:hi].to(device, non_blocking=True)
    out = torch.zeros((hi - lo,) + tuple(t.shape[1:]), dtype=t.dtype, device=device)
    if have:
        out[:have].copy_(t[lo : lo + have], non_blocking=True)
    return out


def shard_rows(t: torch.Tensor, mesh, rows: int | None = None) -> list[torch.Tensor]:
    """``t``'s first ``rows`` rows (all by default; rows past its end are
    zeros) split evenly over the mesh: one tensor a device, in mesh order
    (the counterpart of ``jax.device_put`` with a sharding)."""
    mesh = _devices(mesh)
    m = _shard(t.shape[0] if rows is None else rows, mesh, "rows")
    out = []
    for k, d in enumerate(mesh):
        with _build.on_device(d):
            out.append(_rows(t, k * m, (k + 1) * m, d))
    return out


def _gather(parts, mesh) -> torch.Tensor:
    """The shards' partials stacked on the mesh's first device: [D, ...]."""
    with _build.on_device(mesh[0]):
        return torch.stack([p.to(mesh[0]) for p in parts])


# ---------------------------------------------------------------------------
# The point axis: the fixed-base MSM and the commit
# ---------------------------------------------------------------------------


class ShardedMsmContext:
    """The GLV table of :class:`..ops.msm.MsmContext` split over the point
    axis: shard k holds the table of points k N/D .. (k + 1) N/D - 1 on
    mesh device k (1/D of the mainnet table's 163 MB each), with M2's
    configuration for its width."""

    def __init__(self, n: int, shards: list, mesh):
        self.n = n
        self.shards = shards
        self.mesh = _devices(mesh)

    @classmethod
    def build_from_points(cls, points_affine, mesh) -> "ShardedMsmContext":
        mesh = _devices(mesh)
        n = len(points_affine)
        m = _shard(n, mesh, "points")
        shards = []
        for k, d in enumerate(mesh):
            with _build.on_device(d):
                shards.append(M.MsmContext.build_from_points(points_affine[k * m : (k + 1) * m], d))
        return cls(n, shards, mesh)

    @classmethod
    def build(cls, settings, mesh) -> "ShardedMsmContext":
        return cls.build_from_points(settings.g1_values, mesh)

    def partials(self, digits: torch.Tensor) -> torch.Tensor:
        """digits [2, 26, N] int8 (host or device) -> each shard's M2 over
        its columns, [D, 3, 12] on the mesh's first device."""
        m = self.n // len(self.mesh)
        parts = []
        for k, (d, ctx) in enumerate(zip(self.mesh, self.shards)):
            with _build.on_device(d):
                parts.append(ctx.point(digits[:, :, k * m : (k + 1) * m].to(d).contiguous()))
        return _gather(parts, self.mesh)


def msm_fixed_base_sharded(ctx: ShardedMsmContext, scalars):
    """The MSM over the setup points (canonical Fr ints), point-sharded: the
    host's GLV recoding, each shard's M2, the partials' K3 tree.  The same
    golden affine point (or None) as ``msm.msm_fixed_base``."""
    d1, d2 = M.recode_glv_host(scalars)
    parts = ctx.partials(torch.from_numpy(np.stack([d1, d2])))
    with _build.on_device(ctx.mesh[0]):
        return C.proj_to_points(C.sum_points(parts)[None].cpu())[0]


def sharded_commit(ctx: ShardedMsmContext, blob_bytes: torch.Tensor):
    """``blob_to_kzg_commitment`` with the blob's field-element axis split
    with the table (element i multiplies setup point i): each shard ingests
    and checks its elements and runs M1 and M2 on them
    (:func:`..ops.prover_kernels.commit`).  blob_bytes [N, 32] uint8 (host
    or device) -> (commitment [3, 12] projective Montgomery, ok), both on
    the mesh's first device; ok is False iff an element is >= r."""
    m = _shard(blob_bytes.shape[0], ctx.mesh, "field elements")
    points, oks = [], []
    for k, (d, shard) in enumerate(zip(ctx.mesh, ctx.shards)):
        with _build.on_device(d):
            point, ok = PR.commit(shard, _rows(blob_bytes, k * m, (k + 1) * m, d))
        points.append(point)
        oks.append(ok)
    with _build.on_device(ctx.mesh[0]):
        return C.sum_points(_gather(points, ctx.mesh)), _gather(oks, ctx.mesh).all()


# ---------------------------------------------------------------------------
# The domain axis: one blob's barycentric evaluation
# ---------------------------------------------------------------------------


class ShardedFrContext:
    """:class:`..ops.protocol_kernels.FrContext` split over the domain: shard
    k holds roots k n/D .. (k + 1) n/D - 1 (in both Montgomery forms) on
    mesh device k, with the whole domain's n and mont(1/n) in the port's
    radix."""

    def __init__(self, shards: list, mesh):
        self.shards = shards
        self.mesh = _devices(mesh)
        self.n = shards[0].n

    @classmethod
    def build(cls, settings, mesh) -> "ShardedFrContext":
        mesh = _devices(mesh)
        n = settings.preset.field_elements_per_blob
        roots = settings.roots_of_unity
        m = _shard(n, mesh, "domain elements")
        shards = []
        for k, d in enumerate(mesh):
            with _build.on_device(d):
                shards.append(PK.FrContext.from_roots(n, roots[k * m : (k + 1) * m], d))
        return cls(shards, mesh)


def sharded_bary(ctx: ShardedFrContext, evals: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The barycentric evaluation with the domain split over the mesh:
    evals [n, B, 8] canonical (domain-major, host or device), xs [B, 8]
    canonical and out of the domain -> ys [B, 8] canonical on the mesh's
    first device, the single-device values.  Each shard sums its
    e_i w_i / (x - w_i) with its own batch inversion
    (:func:`..ops.verify_kernels.bary_partial`); the Fr partials are added
    pairwise with the Fr add; then the (x^n - 1) / n scaling."""
    m = _shard(evals.shape[0], ctx.mesh, "domain elements")
    parts = []
    for k, (d, shard) in enumerate(zip(ctx.mesh, ctx.shards)):
        with _build.on_device(d):
            x_m = L.to_mont(FR, xs.to(d))
            parts.append(V.bary_partial(shard, _rows(evals, k * m, (k + 1) * m, d), x_m)[0])
    dev = ctx.mesh[0]
    with _build.on_device(dev):
        s = _gather(parts, ctx.mesh)
        while s.shape[0] > 1:
            h = s.shape[0] // 2
            red = L.add_mod(FR, s[:h], s[h : 2 * h])
            s = torch.cat([red, s[2 * h :]]) if s.shape[0] % 2 else red
        return V.bary_finish(ctx.shards[0], s[0], L.to_mont(FR, xs.to(dev)))


# ---------------------------------------------------------------------------
# The blob axis: batch verification's three stages
# ---------------------------------------------------------------------------


def sharded_batch_points(comp_bytes: torch.Tensor, mesh):
    """Stage 1 with the blobs split over the mesh: comp_bytes [2B, 48] uint8
    blob-major (host or device) -> (bases, bases2, flags): each shard's
    window bases [W, 2B/D, 3, 12] stay on its device, where stage 2 reads
    them (lists in mesh order); ``flags`` [2] int32, every shard's flags
    AND-combined on the mesh's first device."""
    mesh = _devices(mesh)
    m = _shard(comp_bytes.shape[0], mesh, "point rows")
    parts = []
    for k, d in enumerate(mesh):
        with _build.on_device(d):
            parts.append(V.batch_points(_rows(comp_bytes, k * m, (k + 1) * m, d)))
    return [p[0] for p in parts], [p[1] for p in parts], _gather([p[2] for p in parts], mesh).amin(0)


def sharded_bary_blobs(ctxs, blob_bytes, xs: torch.Tensor, mesh):
    """The batch's ingest, canonicality check and barycentric evaluation with
    the blobs split over the mesh: ``ctxs`` one FrContext a mesh device,
    xs [B, 8] canonical for the padded batch, blob_bytes [n, fe, 32] uint8
    (host or device; B >= n, the rows past n being zero blobs made on the
    card) or its B rows already split by :func:`shard_rows` -> (ys [B, 8]
    canonical, ok) on the mesh's first device."""
    mesh = _devices(mesh)
    m = _shard(xs.shape[0], mesh, "blobs")
    if not isinstance(blob_bytes, list):
        blob_bytes = shard_rows(blob_bytes, mesh, xs.shape[0])
    ys, oks = [], []
    for k, (d, ctx) in enumerate(zip(mesh, ctxs)):
        with _build.on_device(d):
            y, ok = V.bary_batch_from_bytes(ctx, blob_bytes[k], _rows(xs, k * m, (k + 1) * m, d))
        ys.append(y)
        oks.append(ok)
    with _build.on_device(mesh[0]):
        return _gather(ys, mesh).reshape(-1, FR.nwords), _gather(oks, mesh).all()


def batch_stage2_partials(bases, bases2, digits: torch.Tensor, mesh) -> torch.Tensor:
    """Each shard's stage-2 partials over its own blobs' lanes (the
    blob-major digit layout makes a shard's columns self-contained):
    ``bases``/``bases2`` as :func:`sharded_batch_points` leaves them, digits
    [W, 6B] int8 (host or device) -> [D, 2, 3, 12] on the mesh's first
    device."""
    mesh = _devices(mesh)
    m = _shard(digits.shape[1], mesh, "stage-2 lanes")
    parts = []
    for k, (d, b1, b2) in enumerate(zip(mesh, bases, bases2)):
        with _build.on_device(d):
            parts.append(V.stage2_partials(b1, b2, digits[:, k * m : (k + 1) * m].to(d).contiguous()))
    return _gather(parts, mesh)


def reduce_stage2(parts: torch.Tensor, gen_table, sy_digits) -> torch.Tensor:
    """Stage 2's tail on the partials' device: [P, 2, 3, 12] partials -> [2,
    3, 12], row 0 the sum of row 0s, row 1 the sum of row 1s less
    [sum r^i y_i] G (the generator table and its digits on that device)."""
    lhs = C.sum_points(parts[:, 0].contiguous())
    rhs = C.sum_points(parts[:, 1].contiguous())
    rhs = C.proj_add(rhs, C.point_neg(V.gen_mult(gen_table, sy_digits)))
    return torch.stack([lhs, rhs])


def sharded_batch_stage2(bases, bases2, digits, gen_table, sy_digits, mesh) -> torch.Tensor:
    """Stage 2 with the blobs split over the mesh; the single-device
    :func:`..ops.verify_kernels.batch_stage2`'s group elements, as [2, 3,
    12] on the mesh's first device."""
    mesh = _devices(mesh)
    parts = batch_stage2_partials(bases, bases2, digits, mesh)
    with _build.on_device(mesh[0]):
        return reduce_stage2(parts, gen_table, sy_digits)
