"""The prover on the device: ``blob_to_kzg_commitment`` and
``compute_kzg_proof`` as launch sequences on one stream.

Counterpart of the JAX package's ``ops/prover_kernels.py``, whose
``commit_kernel`` and ``proof_kernel`` are one jitted program each
(reference call stacks: SURVEY.md sections 3.2-3.3).  Here each is a
sequence of the hand-written kernels with no host round trip inside:

* blob ingest and the canonicality flag (``limbs.ingest_check``, one
  launch of ``kzg_fr_ingest``);
* in :func:`proof` only, y and the quotient: out of the domain the
  single-blob barycentric evaluation, whose inverses the quotient reuses
  (one negation instead of a second inversion); in the domain y is the
  blob's element there and the in-domain quotient.  The JAX program picks
  the branch on the device with ``lax.cond``; the host knows z and picks it
  here (the caller passes the root's index), with the same results;
* the MSM: M1 (the digits) and M2 (the point: its accumulation and
  reduction in one launch).

Both return device tensors; the caller fetches them in one copy.  Points
stay projective Montgomery words (the host converts the one point), y is
canonical.  ``mark(key)``, when given, is called around each part with
``"<part>.start"`` / ``"<part>.end"`` for ``part`` in quotient, digits
and accumulate (M2).
"""

from __future__ import annotations

import torch

from . import limbs as L
from . import msm as M
from . import protocol_kernels as PK
from .limbs import FR


def _no_mark(key: str) -> None:
    pass


def ingest(blob_bytes: torch.Tensor):
    """[n, 32] uint8 big-endian field elements -> (evals [n, 8] words, ok:
    a bool scalar, False iff an element is >= r; the results of a blob that
    is not ok are garbage and the caller raises)."""
    return L.ingest_check(blob_bytes)


def msm(ctx: M.MsmContext, scalars: torch.Tensor, mark=_no_mark) -> torch.Tensor:
    """sum_i scalars_i P_i over the setup points: canonical Fr words [n, 8]
    -> one projective Montgomery point [3, 12]; M1 and M2 once each."""
    mark("digits.start")
    digits = M.glv_digits_from_limbs(scalars)
    mark("digits.end")
    mark("accumulate.start")
    point = ctx.point(digits)
    mark("accumulate.end")
    return point


def commit(ctx: M.MsmContext, blob_bytes: torch.Tensor, mark=_no_mark):
    """-> (commitment [3, 12], ok)."""
    evals, ok = ingest(blob_bytes)
    return msm(ctx, evals, mark), ok


def proof(fr: PK.FrContext, ctx: M.MsmContext, blob_bytes: torch.Tensor, z: int, m, mark=_no_mark):
    """The whole ``compute_kzg_proof_impl`` (reference: kzg.rs:461-528) for
    a canonical z; ``m`` is z's index in the domain, or None.  Returns
    (proof [3, 12], y [8] canonical, ok)."""
    mark("quotient.start")
    evals, ok = ingest(blob_bytes)
    zw = L.to_device(FR, [z], blob_bytes.device)[0]
    if m is None:
        y, inv = PK.barycentric_eval_inv(fr, evals, zw)
        q = PK.quotient_out_of_domain(fr, evals, zw, y, inv=inv)
    else:
        y = evals[m]
        q = PK.quotient_in_domain(fr, evals, zw, y, m)
    mark("quotient.end")
    return msm(ctx, q, mark), y, ok
