"""Scale-out over processes: ranks joined by ``torch.distributed``, each over
the cards of its own host.

Counterpart of the JAX package's ``parallel/distributed.py``, whose
2-axis ``(host, chip)`` mesh becomes a :class:`HostChipMesh`: this rank,
the world's size and this rank's local devices.  A batch's blob axis (or
the setup's point axis) splits first over the ranks, then over each rank's
local devices as :mod:`.sharded` splits it; each rank's [2, 3, 12] (or
[3, 12]) partials, one a local device, then go through ``dist.all_gather``
and every rank runs the same tail on all of them.  Every rank is given the
whole input and takes its own slice.

:func:`initialize_distributed` joins the world (NCCL on cards, gloo on the
CPU); the caller gives the address, the world's size and its rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build
from ..ops import curve as C
from ..ops import msm as M
from . import sharded as S


def initialize_distributed(init_method: str | None = None, world_size: int | None = None, rank: int | None = None, backend: str | None = None, timeout=None) -> None:
    """Join (or start) the world: ``torch.distributed.init_process_group``
    with ``backend`` (NCCL where CUDA is available, gloo otherwise) at
    ``init_method`` (``tcp://host:port``; ``env://``, reading MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE and RANK, by default).  Once per process,
    before any call of this module; a coordinator that cannot be reached
    raises there (after ``timeout``, a ``datetime.timedelta``)."""
    import torch.distributed as dist

    kwargs = {"init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"), **kwargs)


class HostChipMesh(NamedTuple):
    """This rank of the world and its local devices (a 1-axis mesh of
    :mod:`.sharded`)."""

    rank: int
    world: int
    devices: list


def host_chip_mesh(devices=None) -> HostChipMesh:
    """This rank's place in the initialised world, over ``devices`` (by
    default every visible CUDA device)."""
    import torch.distributed as dist

    local = S.default_mesh() if devices is None else [torch.device(d) for d in devices]
    return HostChipMesh(dist.get_rank(), dist.get_world_size(), local)


def _rank_slice(total: int, mesh: HostChipMesh, what: str) -> tuple[int, int]:
    """This rank's rows of ``total``, which must split evenly over every
    device of the world."""
    if total % (mesh.world * len(mesh.devices)):
        raise ValueError(f"{total} {what} not divisible by {mesh.world} ranks x {len(mesh.devices)} devices")
    m = total // mesh.world
    return mesh.rank * m, (mesh.rank + 1) * m


def _all_gather(t: torch.Tensor, mesh: HostChipMesh) -> torch.Tensor:
    """Every rank's ``t`` [k, ...], joined in rank order along axis 0, on
    this rank's first device (NCCL gathers on the card, gloo on the CPU)."""
    import torch.distributed as dist

    dev = mesh.devices[0]
    with _build.on_device(dev):
        src = t.contiguous() if dist.get_backend() == "nccl" else t.cpu().contiguous()
        out = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(out, src)
        return torch.cat(out).to(dev)


def batch_points_2axis(comp_bytes: torch.Tensor, mesh: HostChipMesh):
    """Stage 1 over the world: this rank's rows of the [2B, 48] compressed
    points split over its devices (:func:`.sharded.sharded_batch_points`),
    the flags AND-combined over every device of every rank.  Returns this
    rank's bases and bases2 (one tensor a local device) and the flags."""
    lo, hi = _rank_slice(comp_bytes.shape[0], mesh, "point rows")
    bases, bases2, flags = S.sharded_batch_points(comp_bytes[lo:hi], mesh.devices)
    return bases, bases2, _all_gather(flags[None], mesh).amin(0)


def batch_stage2_2axis(bases, bases2, digits: torch.Tensor, gen_table, sy_digits, mesh: HostChipMesh) -> torch.Tensor:
    """Stage 2 over the world: this rank's columns of the [W, 6B] digits on
    its bases, one [2, 3, 12] partial a local device, all gathered over the
    ranks, then the tail of :func:`.sharded.reduce_stage2` on every rank
    (``gen_table`` and ``sy_digits`` on this rank's first device)."""
    lo, hi = _rank_slice(digits.shape[1], mesh, "stage-2 lanes")
    parts = _all_gather(S.batch_stage2_partials(bases, bases2, digits[:, lo:hi], mesh.devices), mesh)
    with _build.on_device(mesh.devices[0]):
        return S.reduce_stage2(parts, gen_table, sy_digits)


class ShardedMsmContext2Axis:
    """The GLV table split over the world: this rank holds the table of its
    slice of the setup points, split over its devices
    (:class:`.sharded.ShardedMsmContext`)."""

    def __init__(self, n: int, local: S.ShardedMsmContext, mesh: HostChipMesh):
        self.n = n
        self.local = local
        self.mesh = mesh

    @classmethod
    def build_from_points(cls, points_affine, mesh: HostChipMesh) -> "ShardedMsmContext2Axis":
        lo, hi = _rank_slice(len(points_affine), mesh, "points")
        return cls(len(points_affine), S.ShardedMsmContext.build_from_points(points_affine[lo:hi], mesh.devices), mesh)

    @classmethod
    def build(cls, settings, mesh: HostChipMesh) -> "ShardedMsmContext2Axis":
        return cls.build_from_points(settings.g1_values, mesh)


def msm_fixed_base_2axis(ctx: ShardedMsmContext2Axis, scalars):
    """The MSM over the setup points split over the world: the host's GLV
    recoding, this rank's columns through its local shards, every rank's
    [3, 12] partials gathered and summed with the K3 tree.  The same golden
    affine point (or None) on every rank as ``msm.msm_fixed_base``."""
    d1, d2 = M.recode_glv_host(scalars)
    lo, hi = _rank_slice(ctx.n, ctx.mesh, "points")
    parts = _all_gather(ctx.local.partials(torch.from_numpy(np.stack([d1, d2])[:, :, lo:hi])), ctx.mesh)
    with _build.on_device(ctx.mesh.devices[0]):
        return C.proj_to_points(C.sum_points(parts)[None].cpu())[0]
