"""PyTorch/CUDA backend.

Runs on the card, as launch sequences of the hand-written CUDA kernels:

* ``verify_blob_kzg_proof_batch`` as three device stages
  (:mod:`kzg_rust_tpu_torch.ops.verify_kernels`) followed by one pairing on
  the host: the single-device branches of the JAX package's
  ``jax_backend.JaxBackend._verify_batch_device``.  Batch sizes are padded
  to powers of two (at least 4) with infinity points and zero blobs, which
  are identities through every stage.  Large batches run stage 1 and the
  barycentric evaluation in blob chunks (``STAGE1_CHUNK_BLOBS``,
  ``BARY_CHUNK_BLOBS``): each barycentric chunk is copied from the callers'
  bytes into one of two pinned staging buffers, uploaded on a copy stream
  while the card evaluates the chunk before it, and evaluated by one replay
  of a CUDA graph;
* the prover, ``blob_to_kzg_commitment`` and ``compute_kzg_proof`` (and
  through it ``compute_blob_kzg_proof``), each one device sequence
  (:mod:`kzg_rust_tpu_torch.ops.prover_kernels`) and one fetch: the device
  branch of ``jax_backend`` ``blob_to_commitment_pipeline`` and
  ``compute_kzg_proof_pipeline``.  Below 8 setup points there is no MSM
  table and the calls take the host path, as the JAX backend does (the
  reference goes naive there, utils.rs:369-371);
* the polynomial math of the piecewise protocol path (the single-blob
  barycentric evaluation behind ``verify_blob_kzg_proof``, the quotients)
  and the fixed-base MSM.

The host work between the launches (the pairing that ends a batch, the
point decoding and subgroup checks of the protocol layer, and the G1/G2
multiplies and pairing of single-proof verification, inherited from
GoldenBackend) goes through :mod:`kzg_rust_tpu_torch.hostcrypto`, i.e. the
native C++ host engine where it loads.

Placement is the caller's choice, per call, through two environment
variables, each ``device`` (the default), ``host``, ``auto`` or
``host-piecewise``:

* ``KZG_TORCH_EVAL`` for verification: ``host`` runs
  ``verify_blob_kzg_proof_batch``, ``verify_kzg_proof`` and
  ``verify_blob_kzg_proof`` each as one call of the engine's fused
  ``VerifyCtx``;
* ``KZG_TORCH_PROVER`` for the prover: ``host`` runs
  ``blob_to_kzg_commitment``, ``compute_kzg_proof`` and
  ``compute_blob_kzg_proof`` each as one call of its ``ProverCtx``.

``host`` without the engine raises RuntimeError.  ``auto`` is the JAX
package's measured placement (:mod:`.placement`), decided per call: a batch
and each prover call go to the card exactly when the link's measured cost
plus the card's fitted time beats the engine's measured time for that call
(:meth:`TorchBackend._auto_prefers_device`); ``verify_kzg_proof`` and
``verify_blob_kzg_proof`` take the engine.  On a CPU backend ``auto`` is the
host; without the engine it is the device path.  The default stays
``device``, where the JAX package's is ``auto``: the port's entry points
run on the card unless the caller asks otherwise.  ``KZG_TORCH_EVAL=
host-piecewise`` is the JAX backend's: ``verify_blob_kzg_proof_batch`` in
the engine's separate calls (decompression, subgroup checks, the
barycentric evaluations of ``BaryCtx``, the lincombs, the pairing) with
the challenges and the RLC scalars in Python, and RuntimeError without
the engine; the single-proof calls and ``KZG_TORCH_PROVER=host-piecewise``
take the device path, as in the JAX backend.

With more than one visible card, a batch, the commit, the MSM and the
single-blob barycentric evaluation split over a mesh of them
(:mod:`..parallel.sharded`; ``KZG_TORCH_SHARD=0`` keeps one card): the
largest power of two of cards that divides the batch, the setup's points or
the domain.  Every device entry point runs under ``torch.cuda.device`` of
the backend's card, so ``TorchBackend(device="cuda:1")`` needs no current
card of its caller.

On a CUDA device the constructor builds and loads the engine and raises
where it does not load (unless ``KZG_TORCH_NATIVE=0``).

``TorchBackend()`` runs on the current CUDA device and raises where CUDA is
absent; only an explicit ``TorchBackend(device="cpu")`` runs the kernels'
plain PyTorch versions (the CPU tests).
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import time

import numpy as np
import torch

from .. import hostcrypto, native
from ..errors import BadArgs
from ..ops._build import on_device
from . import placement as P
from ..messages import (
    MSG_BLOB_LENGTH,
    MSG_EXPECT_48,
    MSG_INVALID_BYTES32,
    MSG_INVALID_COMPRESSED_G1,
    MSG_NOT_IN_SUBGROUP,
)
from .golden_backend import GoldenBackend

STAGES = ("stage1", "bary", "stage2", "quotient", "digits", "accumulate")

# Blob-chunked barycentric evaluation, from npad >= 2 * BARY_CHUNK_BLOBS:
# each chunk's blobs are uploaded while the card evaluates the chunk before
# it, and the evaluation's working set stays one chunk wide.  64 had the
# best median end to end of chip_smoke.py's sweep (64-512) at n = 4096 on
# an NVIDIA H100, all four inside the host's spread (PERF.md section 5).
BARY_CHUNK_BLOBS = 64
# Stage 1 in chunks of this many blobs from npad >= 2 * STAGE1_CHUNK_BLOBS;
# the parts' window bases are joined on the card and their flags
# AND-combined.  Full width won the H100 sweep at n = 4096 (PERF.md
# section 5), so the branch starts above 4096, where it bounds stage 1's
# memory.
STAGE1_CHUNK_BLOBS = 4096
# Blobs a task of the hash pool hashes in turn.
HASH_GROUP = 16


def _pow2_pad(n: int, lo: int = 2) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


_HASH_POOL = None
_HASH_POOL_LOCK = threading.Lock()


def _hash_pool():
    """Shared executor for GIL-releasing SHA-256 work."""
    global _HASH_POOL
    if _HASH_POOL is None:
        with _HASH_POOL_LOCK:
            if _HASH_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _HASH_POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 4)
    return _HASH_POOL


def _challenges(prefix: bytes, blobs, commitments) -> list[int]:
    """The Fiat-Shamir challenge of each (blob, commitment): SHA-256 over
    ``prefix``, the blob and the commitment, fed in turn (the same digest as
    ``bls_serde.challenge_preimage`` joined; hashlib drops the GIL on the
    blob), reduced mod r."""
    from ..utils import bls_serde as serde

    out = []
    for blob, c in zip(blobs, commitments):
        h = hashlib.sha256(prefix)
        h.update(blob)
        h.update(bytes(c))
        out.append(serde.hash_to_bls_field(h.digest()))
    return out


class _Challenges:
    """A batch's challenges, hashed in the shared pool in groups of
    HASH_GROUP blobs from construction on (inline below 8 blobs); ``get``
    waits only for the groups it needs."""

    def __init__(self, preset, blobs, commitments):
        from ..presets import FIAT_SHAMIR_PROTOCOL_DOMAIN
        from ..utils import bls_serde as serde

        prefix = FIAT_SHAMIR_PROTOCOL_DOMAIN + serde.bytes_from_uint64(0) + serde.bytes_from_uint64(preset.field_elements_per_blob)
        n = len(blobs)
        if n < 8:
            self._groups = [_challenges(prefix, blobs, commitments)]
            self._width = max(n, 1)
            return
        pool = _hash_pool()
        self._width = HASH_GROUP
        self._groups = [
            pool.submit(_challenges, prefix, blobs[i : i + HASH_GROUP], commitments[i : i + HASH_GROUP])
            for i in range(0, n, HASH_GROUP)
        ]

    def get(self, lo: int, hi: int) -> list[int]:
        """The challenges of blobs lo..hi-1."""
        if hi <= lo:
            return []
        w = self._width
        out = []
        for g in range(lo // w, -(-hi // w)):
            part = self._groups[g]
            out += part if isinstance(part, list) else part.result()
        return out[lo - (lo // w) * w :][: hi - lo]


class _BaryChunks:
    """The chunked barycentric evaluation for one (settings, device, chunk
    width), cached in ``settings._device_cache`` and freed with it.

    Chunk k runs in three steps.  :meth:`wait` waits for the upload that
    last read staging buffer k % 2.  :meth:`stage` copies the chunk's blobs
    from the callers' bytes into that buffer (one copy a blob) and, on the
    card, enqueues that buffer's upload into landing buffer k % 2 on a copy
    stream of its own.  :meth:`run` copies the landed rows into the static
    input ``blob_in`` on the current stream (which waits on the upload's
    event), zeroes the pad rows there, puts the chunk's xs into ``xs_in``
    and replays one CUDA graph of ``bary_batch_from_bytes(ctx, blob_in,
    xs_in, tickets, flag)``, captured once (``tickets``, its domain sum's,
    and ``flag``, its ingest's ok byte, are this object's alone); it
    returns the graph's static (ys, ok), which
    the caller copies out before the next run.  So chunk k + 1's upload runs
    while the card evaluates chunk k.  The copy stream waits on a landing
    buffer's last read before it overwrites it.

    On the CPU the staging buffer is ``blob_in`` itself, and ``run`` calls
    the plain versions: no pinning, no copy stream, no graph.  Pinning,
    copies and the capture raise where they fail."""

    def __init__(self, ctx, device, width: int, fe: int):
        from ..ops import _build
        from ..ops import limbs as L
        from ..ops import verify_kernels as V
        from ..ops.limbs import FR

        self.ctx, self.width = ctx, width
        self.lock = threading.Lock()
        self.blob_in = torch.zeros((width, fe, 32), dtype=torch.uint8, device=device)
        self.xs_in = torch.zeros((width, FR.nwords), dtype=torch.int32, device=device)
        self.graph = None
        if device.type == "cpu":
            self.staging = [self.blob_in]
            return
        self.staging = [torch.empty((width, fe, 32), dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        self.landing = [torch.empty((width, fe, 32), dtype=torch.uint8, device=device) for _ in range(2)]
        self.copy_stream = torch.cuda.Stream(device)
        self.uploaded = [torch.cuda.Event() for _ in range(2)]
        self.consumed = [torch.cuda.Event() for _ in range(2)]
        self.tickets = L.sum_tickets(width, device)  # the graph's domain sum's, its own
        self.flag = torch.empty((), dtype=torch.uint8, device=device)  # the graph's ingest's, set each replay
        self.graph = _build.Graph(
            "graph:bary_chunk",
            lambda: V.bary_batch_from_bytes(ctx, self.blob_in, self.xs_in, self.tickets, self.flag),
            device,
        )

    def wait(self, k: int) -> None:
        """Host: wait for the upload that last read chunk k's staging buffer."""
        if self.graph is not None:
            self.uploaded[k % 2].synchronize()

    def stage(self, k: int, blobs) -> None:
        slot = k % len(self.staging)
        buf = self.staging[slot].numpy().reshape(self.width, -1)
        for j, blob in enumerate(blobs):
            buf[j] = np.frombuffer(blob, dtype=np.uint8)
        if self.graph is None or not blobs:
            return
        rows = len(blobs)
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(self.consumed[slot])
            self.landing[slot][:rows].copy_(self.staging[slot][:rows], non_blocking=True)
            self.uploaded[slot].record(self.copy_stream)

    def run(self, k: int, rows: int, xs: torch.Tensor):
        from ..ops import verify_kernels as V

        if self.graph is not None and rows:
            slot = k % len(self.staging)
            cur = torch.cuda.current_stream(self.blob_in.device)
            cur.wait_event(self.uploaded[slot])
            self.blob_in[:rows].copy_(self.landing[slot][:rows])
            self.consumed[slot].record(cur)
        if rows < self.width:
            self.blob_in[rows:].zero_()
        self.xs_in.copy_(xs, non_blocking=True)
        if self.graph is None:
            return V.bary_batch_from_bytes(self.ctx, self.blob_in, self.xs_in)
        self.graph.replay()
        return self.graph.outputs


PLACEMENTS = ("device", "host", "auto", "host-piecewise")


def placement(var: str) -> str:
    """One of :data:`PLACEMENTS`, as the environment variable ``var``
    (``KZG_TORCH_EVAL`` or ``KZG_TORCH_PROVER``) asks; ``device`` when unset."""
    mode = os.environ.get(var, "device")
    if mode not in PLACEMENTS:
        raise ValueError(f"{var}={mode!r}: expected one of {', '.join(PLACEMENTS)}")
    return mode


def _on_own_device(method):
    """Run a device entry point under ``torch.cuda.device(self.device)``."""

    @functools.wraps(method)
    def bound(self, *args, **kwargs):
        with on_device(self.device):
            return method(self, *args, **kwargs)

    return bound


class TorchBackend(GoldenBackend):
    name = "torch"

    def __init__(self, device=None, time_stages: bool = False):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: CUDA is not available; pass device='cpu' to run "
                    "the kernels' plain versions"
                )
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # On the card the host work between launches runs in the native
        # engine: a failed build fails here, not as a quiet switch to the
        # golden model, which only KZG_TORCH_NATIVE=0 asks for.
        if self.device.type == "cuda" and native.wanted():
            native.require()
        self._ctx = {}
        # auto placement: the decisions logged so far, (op, n, outcome), and
        # the last decision with its terms (milliseconds).
        self._placement_logged = set()
        self.last_placement: dict = {}
        # With time_stages on a CUDA device, each call records a pair of
        # CUDA events around every stage (stage_ms() reads them) and the
        # host's milliseconds between its steps (host_ms).
        self.time_stages = time_stages and self.device.type == "cuda"
        self._events = {}
        self.host_ms = {}
        self._t = 0.0

    # -- stage timing ---------------------------------------------------------

    def _mark(self, key: str) -> None:
        if self.time_stages:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self._events[key] = ev

    def _lap(self, step: str) -> None:
        """Add the host's milliseconds since the last lap to ``step`` (a step
        a chunk loop repeats sums its laps; all laps add up to the call)."""
        if self.time_stages:
            now = time.perf_counter()
            self.host_ms[step] = self.host_ms.get(step, 0.0) + (now - self._t) * 1e3
            self._t = now

    def _start_timing(self) -> None:
        self._events, self.host_ms = {}, {}
        self._t = time.perf_counter()

    def stage_ms(self) -> dict:
        """Device milliseconds of each stage of the last call (CUDA events;
        includes any idle gaps while the host enqueued the stage)."""
        torch.cuda.synchronize(self.device)
        return {
            s: self._events[s + ".start"].elapsed_time(self._events[s + ".end"])
            for s in STAGES
            if s + ".end" in self._events
        }

    # -- batched blob verification (device pipeline) --------------------------

    @_on_own_device
    def verify_blob_batch_pipeline(
        self, settings, blobs, commitments_bytes, proofs_bytes
    ) -> bool:
        """Batched re-expression of the reference's per-blob loop + RLC
        combination (reference: kzg.rs:637-693, :579-627).  Same validation
        and bit-exact outcomes; execution is three device stages, or one
        call of the host engine with ``KZG_TORCH_EVAL=host`` (or ``auto``
        where the engine is measured faster for this n)."""
        preset = settings.preset
        n = len(blobs)
        bary = None
        if placement("KZG_TORCH_EVAL") == "host-piecewise":
            bary = self._bary_native_ctx(settings)
            if bary is None:
                raise RuntimeError("KZG_TORCH_EVAL=host-piecewise but the native host engine is not available")
        host = self._host_ctx(
            "KZG_TORCH_EVAL",
            self._verify_native_ctx,
            settings,
            # the blobs and two 48-byte points each cross the link
            lambda: self._auto_prefers_device(settings, n, n * (preset.bytes_per_blob + 96), "verify_batch"),
        )
        for b in blobs:
            if len(b) != preset.bytes_per_blob:
                raise BadArgs(MSG_BLOB_LENGTH)
        # The engine reads exactly 48 bytes a point: a wrong length must
        # raise here, not read past the joined buffer.
        for b in list(commitments_bytes) + list(proofs_bytes):
            if len(bytes(b)) != 48:
                raise BadArgs(MSG_EXPECT_48)
        if bary is not None:
            return self._verify_batch_piecewise(settings, blobs, commitments_bytes, proofs_bytes, bary)
        if host is None:
            return self._verify_batch_device(settings, blobs, commitments_bytes, proofs_bytes)
        comms = b"".join(bytes(b) for b in commitments_bytes)
        proofs = b"".join(bytes(b) for b in proofs_bytes)
        if all(isinstance(b, bytes) for b in blobs):
            # Only the blobs' pointers cross the boundary, not their bytes.
            return host.verify_scatter(blobs, n, comms, proofs)
        return host.verify(b"".join(bytes(b) for b in blobs), n, comms, proofs)

    def verify_kzg_proof_pipeline(self, settings, commitment_bytes, z_bytes, y_bytes, proof_bytes):
        """``verify_kzg_proof`` (reference: kzg.rs:429-443) as one call of
        the host engine with ``KZG_TORCH_EVAL=host`` or ``auto`` (where the
        engine loads, as the JAX backend places it); NotImplemented (the
        protocol's piecewise path) on the device, and for a wrong length,
        whose exact error the piecewise path raises."""
        host = self._host_ctx("KZG_TORCH_EVAL", self._verify_native_ctx, settings)
        if host is None or (len(commitment_bytes), len(z_bytes), len(y_bytes), len(proof_bytes)) != (48, 32, 32, 48):
            return NotImplemented
        return host.verify_single(bytes(commitment_bytes), bytes(z_bytes), bytes(y_bytes), bytes(proof_bytes))

    def verify_blob_pipeline(self, settings, blob, commitment_bytes, proof_bytes):
        """``verify_blob_kzg_proof`` (reference: kzg.rs:547-569) as one call
        of the host engine with ``KZG_TORCH_EVAL=host`` or ``auto`` (where
        the engine loads); NotImplemented on
        the device (the piecewise path, its barycentric evaluation on the
        card)."""
        host = self._host_ctx("KZG_TORCH_EVAL", self._verify_native_ctx, settings)
        if host is None:
            return NotImplemented
        if len(blob) != settings.preset.bytes_per_blob:
            raise BadArgs(MSG_BLOB_LENGTH)
        if len(commitment_bytes) != 48 or len(proof_bytes) != 48:
            return NotImplemented
        return host.verify_blob_single(bytes(blob), bytes(commitment_bytes), bytes(proof_bytes))

    # -- host placement -------------------------------------------------------

    def _host_ctx(self, var: str, ctx, settings, prefers_device=lambda: False):
        """The engine's context ``ctx(settings)`` when ``var`` places this
        call on the host, None for the device.  ``host`` without the engine
        raises RuntimeError; ``auto`` is the device without the engine or
        where ``prefers_device()`` (the measured rule) says so, else the
        host."""
        mode = placement(var)
        if mode in ("device", "host-piecewise"):
            return None
        host = ctx(settings)
        if host is None:
            if mode == "host":
                raise RuntimeError(f"{var}=host but the native host engine is not available")
            return None
        if mode == "auto" and prefers_device():
            return None
        return host

    def _auto_prefers_device(self, settings, n_blobs: int, upload_bytes: int, op: str) -> bool:
        """``auto``: the card for this call exactly when its estimate beats
        the engine's measured time for it (:mod:`.placement`), per call, so
        that the choice follows n.  The estimate is ``AUTO_RTT_CROSSINGS``
        round trips plus the upload plus the card's fitted time, or, where
        the port overlaps the upload with the card's work (a batch in the
        unsharded chunked regime, decided on the padded npad as
        :meth:`_verify_batch_device` decides it), the round trips plus the
        larger of the two; a sharded batch uploads in one transfer and
        keeps the sum.  A CPU backend takes the host.  The decision's terms
        are kept in ``last_placement`` and logged at INFO once per (op, n,
        outcome)."""
        if self.device.type != "cuda":
            return False
        bpb = settings.preset.bytes_per_blob
        if op == "prover":
            host_s = P.host_prove_profile(self._prover_native_ctx(settings), bpb)
        else:
            host_s = n_blobs * P.host_verify_profile(self._verify_native_ctx(settings), bpb, n_blobs)
        rtt, bw = P.link_profile(self.device)
        upload_s = upload_bytes / bw
        dev_s = P.device_est(n_blobs, op)
        npad = _pow2_pad(n_blobs, lo=4)
        sharded = op != "prover" and self._batch_mesh(npad) is not None
        overlapped = op != "prover" and not sharded and npad >= 2 * BARY_CHUNK_BLOBS
        est_s = P.AUTO_RTT_CROSSINGS * rtt + (max(upload_s, dev_s) if overlapped else upload_s + dev_s)
        choose_device = est_s < host_s
        self.last_placement = {
            "op": op,
            "n": n_blobs,
            "rtt_ms": rtt * 1e3,
            "h2d_mb_per_s": bw / 1e6,
            "upload_ms": upload_s * 1e3,
            "device_est_ms": dev_s * 1e3,
            "overlapped": overlapped,
            "sharded": sharded,
            "combined_ms": est_s * 1e3,
            "host_budget_ms": host_s * 1e3,
            "choice": "device" if choose_device else "host",
        }
        key = (op, n_blobs, choose_device)
        if key not in self._placement_logged:
            self._placement_logged.add(key)
            P.logger.info(
                "placement auto [%s]: n=%d rtt=%.3fms h2d=%.0fMB/s upload=%.2fms device_est=%.2fms combined=%.2fms%s host_budget=%.2fms -> %s",
                op,
                n_blobs,
                rtt * 1e3,
                bw / 1e6,
                upload_s * 1e3,
                dev_s * 1e3,
                est_s * 1e3,
                " (upload overlaps compute)" if overlapped else (" (sharded)" if sharded else ""),
                host_s * 1e3,
                self.last_placement["choice"],
            )
        return choose_device

    def _auto_mesh(self, n: int, kind: str):
        """A mesh (:mod:`..parallel.sharded`) over ``kind`` (blobs, points or
        domain) of the largest power of two of visible CUDA devices that
        divides ``n``, from this backend's card on; None with one card, on
        the CPU, or with ``KZG_TORCH_SHARD=0``."""
        if self.device.type != "cuda" or os.environ.get("KZG_TORCH_SHARD", "auto") == "0":
            return None
        ndev = torch.cuda.device_count()
        d = 1
        while d * 2 <= ndev and n % (d * 2) == 0:
            d *= 2
        if d < 2:
            return None
        key = (kind + "_mesh", d)
        if key not in self._ctx:
            from ..parallel import sharded as S

            factory = {"blobs": S.blobs_mesh, "points": S.default_mesh, "domain": S.domain_mesh}[kind]
            self._ctx[key] = factory(d, first=self.device)
        return self._ctx[key]

    def _batch_mesh(self, npad: int):
        return self._auto_mesh(npad, "blobs")

    def _points_mesh(self, n: int):
        return self._auto_mesh(n, "points")

    def _domain_mesh(self, n: int):
        return self._auto_mesh(n, "domain")

    def _verify_native_ctx(self, settings):
        """The engine's fused verification context for this setup, or None."""
        cache = settings._device_cache
        if "verify_native" not in cache:
            from ..golden import curve as gcurve
            from ..presets import FIAT_SHAMIR_PROTOCOL_DOMAIN, RANDOM_CHALLENGE_KZG_BATCH_DOMAIN

            cache["verify_native"] = hostcrypto.verify_ctx(
                settings.roots_of_unity,
                settings.g2_values[1],
                gcurve.G2_GENERATOR,
                FIAT_SHAMIR_PROTOCOL_DOMAIN,
                RANDOM_CHALLENGE_KZG_BATCH_DOMAIN,
            )
        return cache["verify_native"]

    def _prover_native_ctx(self, settings):
        """The engine's fused prover context for this setup, or None."""
        cache = settings._device_cache
        if "prover_native" not in cache:
            from ..presets import FIAT_SHAMIR_PROTOCOL_DOMAIN

            cache["prover_native"] = hostcrypto.prover_ctx(
                settings.roots_of_unity, settings.g1_values, FIAT_SHAMIR_PROTOCOL_DOMAIN
            )
        return cache["prover_native"]


    def _bary_native_ctx(self, settings):
        """The engine's barycentric context for this setup, or None."""
        cache = settings._device_cache
        if "bary_native" not in cache:
            cache["bary_native"] = hostcrypto.bary_ctx(settings.roots_of_unity)
        return cache["bary_native"]

    def _verify_batch_piecewise(self, settings, blobs, commitments_bytes, proofs_bytes, bary):
        """``KZG_TORCH_EVAL=host-piecewise`` (the JAX backend's piecewise
        host path, ``jax_backend.py:432-485``): the points decoded in the
        engine, the challenges, the in-domain overrides, the subgroup check,
        ``bary.eval_batch``, the RLC scalars, the two lincombs and the
        pairing, each a host call; the errors in the same order."""
        from ..golden import curve as gcurve
        from ..golden.field import R
        from ..utils import bls_serde as serde

        preset = settings.preset
        n = len(blobs)
        points = hostcrypto.g1_uncompress_batch([bytes(b) for b in commitments_bytes] + [bytes(b) for b in proofs_bytes])
        commitments, proofs = points[:n], points[n:]
        zs = _Challenges(preset, blobs, commitments_bytes).get(0, n)
        xs_eval, overrides = self._in_domain_overrides(settings, blobs, zs)
        if not hostcrypto.g1_subgroup_batch(points):
            raise BadArgs(MSG_NOT_IN_SUBGROUP)
        ys = bary.eval_batch(b"".join(bytes(b) for b in blobs), n, xs_eval)
        for i, y in overrides.items():
            ys[i] = y
        r_powers = serde.compute_r_powers(preset, commitments_bytes, zs, ys, proofs_bytes)
        r_times_z = [(r_powers[i] * zs[i]) % R for i in range(n)]
        ry = sum(rp * y for rp, y in zip(r_powers, ys))
        proof_lincomb = hostcrypto.g1_lincomb_naive(proofs, r_powers)
        rhs_g1 = hostcrypto.g1_sub(
            hostcrypto.g1_lincomb_naive(commitments + proofs, r_powers + r_times_z),
            hostcrypto.g1_mul(gcurve.G1_GENERATOR, ry % R),
        )
        return self.pairings_verify(proof_lincomb, settings.g2_values[1], rhs_g1, gcurve.G2_GENERATOR)

    def _in_domain_overrides(self, settings, blobs, zs):
        """The in-domain short-circuit (reference: kzg.rs:360-362): replace
        any in-domain challenge with a dummy evaluation point and record the
        stored evaluation that must override the kernel's output."""
        from ..utils import bls_serde as serde

        root_index = self._root_index(settings)
        xs_eval = list(zs)
        overrides = {}
        for i, z in enumerate(zs):
            m = root_index.get(z)
            if m is not None:
                chunk = bytes(blobs[i])[m * 32 : (m + 1) * 32]
                overrides[i] = serde.bytes_to_bls_field(chunk)
                xs_eval[i] = 0  # any out-of-domain dummy; result discarded
        return xs_eval, overrides

    @_on_own_device
    def _verify_batch_device(self, settings, blobs, commitments_bytes, proofs_bytes):
        """Stage 1 (decompress, window-base chain, subgroup checks) is
        launched first; the host computes the Fiat-Shamir challenges
        (SHA-256 over the raw blobs, in the hash pool) while the card runs
        it.  Then the barycentric evaluation: from npad >= 2 *
        BARY_CHUNK_BLOBS in chunks (:class:`_BaryChunks`), each chunk's
        upload overlapping the chunk before it, else at full width after
        one upload of the joined blobs.  Then one packed fetch of flags and
        ys, the RLC scalars on the host, stage 2, and one pairing on the
        host.  On a blob mesh (:meth:`_batch_mesh`) the three stages split
        the blobs over its cards (:mod:`..parallel.sharded`), the blobs
        going up in one transfer a card, with no chunks."""
        from ..golden import curve as gcurve
        from ..golden.field import R
        from ..ops import curve as C
        from ..ops import limbs as L
        from ..ops import msm as M
        from ..ops import verify_kernels as V
        from ..ops.limbs import FR
        from ..utils import bls_serde as serde

        dev = self.device
        self._start_timing()
        n = len(blobs)
        preset = settings.preset
        npad = _pow2_pad(n, lo=4)
        pad = npad - n
        mesh = self._batch_mesh(npad)
        chunked = mesh is None and npad >= 2 * BARY_CHUNK_BLOBS

        # Compressed points, blob-major interleave (row 2b = commitment b,
        # row 2b+1 = proof b) per the stage-2 lane layout; padded rows are
        # the canonical infinity encoding (decodes valid, adds nothing).
        inf48 = b"\xc0" + b"\x00" * 47
        rows = []
        for i in range(n):
            rows.append(bytes(commitments_bytes[i]))
            rows.append(bytes(proofs_bytes[i]))
        rows.extend([inf48] * (2 * pad))
        comp = np.frombuffer(bytearray().join(rows), dtype=np.uint8).reshape(2 * npad, 48)

        # Uploads first: a copy from pageable host memory waits for the
        # stream, so one after the stage-1 launches would stall the host
        # until stage 1 ends.  Stage 1 is then enqueued before any host
        # hashing, and the doubling chain runs while the host hashes below.
        # In the chunked regime the blobs go up chunk by chunk instead.
        if mesh is not None:
            from ..parallel import sharded as S

            blob_dev = S.shard_rows(torch.from_numpy(self._blob_bytes_np(settings, blobs)), mesh, npad)
        elif not chunked:
            blob_np = self._blob_bytes_np(settings, blobs)
            blob_dev = torch.zeros((npad,) + blob_np.shape[1:], dtype=torch.uint8, device=dev)
            blob_dev[:n] = torch.from_numpy(blob_np).to(dev)
        comp_dev = self._upload(comp)
        self._lap("pack_upload")
        self._mark("stage1.start")
        if mesh is not None:
            bases, bases2, pflags = S.sharded_batch_points(comp_dev, mesh)
        else:
            bases, bases2, pflags = self._stage1(comp_dev, npad)
        self._mark("stage1.end")
        self._lap("stage1_enqueue")

        # Fiat-Shamir challenges on the host (overlapped with stage 1).
        challenges = _Challenges(preset, blobs, commitments_bytes)
        ctx = self._fr_ctx(settings)
        if chunked:
            self._lap("hash")
            ys_dev, blob_ok, overrides = self._bary_chunked(settings, ctx, blobs, challenges, npad)
        else:
            xs_eval, overrides = self._in_domain_overrides(settings, blobs, challenges.get(0, n))
            xs = self._upload(L.ints_to_words(FR.nwords, xs_eval + [0] * pad))
            self._lap("hash")
            self._mark("bary.start")
            if mesh is not None:
                ctxs = [self._fr_ctx(settings, d) for d in mesh]
                ys_dev, blob_ok = S.sharded_bary_blobs(ctxs, blob_dev, xs, mesh)
            else:
                ys_dev, blob_ok = V.bary_batch_from_bytes(ctx, blob_dev, xs)
            self._mark("bary.end")
            self._lap("bary_enqueue")

        # ONE packed fetch for flags + blob_ok + ys; the host-side
        # validation order is unchanged (point decode -> subgroup -> blob
        # canonicality, reference kzg.rs:671-683).
        arr = self._fetch(pflags, blob_ok, ys_dev)
        self._lap("fetch_wait")
        if not arr[0]:
            raise BadArgs(MSG_INVALID_COMPRESSED_G1)
        if not arr[1]:
            raise BadArgs(MSG_NOT_IN_SUBGROUP)
        if not arr[2]:
            raise BadArgs(MSG_INVALID_BYTES32)
        ys = L.words_to_ints(arr[3:].reshape(npad, FR.nwords)[:n])
        for i, y in overrides.items():
            ys[i] = y

        # RLC scalars (host SHA-256) + GLV recoding to int8 digit matrices.
        zs = challenges.get(0, n)
        r_powers = serde.compute_r_powers(preset, commitments_bytes, zs, ys, proofs_bytes)
        r_times_z = [(r_powers[i] * zs[i]) % R for i in range(n)]
        ry = 0
        for rp, y in zip(r_powers, ys):
            ry += rp * y
        digits = V.stage2_digits(npad, r_powers + [0] * pad, r_times_z + [0] * pad)
        sy_digits = M.recode_signed_digits([ry % R], 1)
        self._lap("rlc")

        self._mark("stage2.start")
        if mesh is not None:
            out = S.sharded_batch_stage2(bases, bases2, self._upload(digits), self._gen_table(), self._upload(sy_digits), mesh)
        else:
            out = V.batch_stage2(bases, bases2, self._upload(digits), self._gen_table(), self._upload(sy_digits))
        self._mark("stage2.end")
        proof_lincomb, rhs_g1 = C.proj_to_points(out.cpu())
        self._lap("stage2")
        ok = self.pairings_verify(proof_lincomb, settings.g2_values[1], rhs_g1, gcurve.G2_GENERATOR)
        self._lap("pairing")
        return ok

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device; on the card through pinned memory
        (the copy does not wait for the stream's work)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _stage1(self, comp_dev, npad):
        """Stage 1 over the compressed rows: at full width, or from npad >=
        2 * STAGE1_CHUNK_BLOBS in chunks of that many blobs, whose window
        bases are joined along the point axis and whose flags are
        AND-combined (the JAX package's chunked branch)."""
        from ..ops import verify_kernels as V

        width = STAGE1_CHUNK_BLOBS
        if npad < 2 * width:
            return V.batch_points(comp_dev)
        parts = [V.batch_points(comp_dev[2 * s : 2 * (s + width)]) for s in range(0, npad, width)]
        bases = torch.cat([p[0] for p in parts], dim=1)
        bases2 = torch.cat([p[1] for p in parts], dim=1)
        return bases, bases2, torch.stack([p[2] for p in parts]).amin(0)

    def _bary_chunked(self, settings, ctx, blobs, challenges, npad):
        """The barycentric evaluation in chunks of BARY_CHUNK_BLOBS blobs
        through :class:`_BaryChunks`: per chunk, wait for its staging
        buffer and stage its blobs, then its
        challenges (waiting for their hash tasks) and in-domain overrides,
        then its run; the ys and each chunk's flag are gathered on the
        card.  Returns (ys [npad, 8], ok, overrides)."""
        from ..ops import limbs as L
        from ..ops.limbs import FR

        width = BARY_CHUNK_BLOBS
        n = len(blobs)
        pipe = self._bary_pipe(settings, ctx, width)
        ys_all = torch.empty((npad, FR.nwords), dtype=torch.int32, device=self.device)
        ok_all = torch.empty(npad // width, dtype=torch.bool, device=self.device)
        overrides = {}
        with pipe.lock:
            self._mark("bary.start")
            for k, s in enumerate(range(0, npad, width)):
                chunk = blobs[s : min(s + width, n)]
                pipe.wait(k)
                self._lap("staging_wait")
                pipe.stage(k, chunk)
                self._lap("stage_chunk_copy")
                xs_eval, over = self._in_domain_overrides(settings, chunk, challenges.get(s, s + len(chunk)))
                overrides.update((s + i, y) for i, y in over.items())
                xs = torch.from_numpy(L.ints_to_words(FR.nwords, xs_eval + [0] * (width - len(chunk))))
                if self.device.type == "cuda":
                    xs = xs.pin_memory()
                self._lap("hash")
                ys, ok = pipe.run(k, len(chunk), xs)
                ys_all[s : s + width].copy_(ys)
                ok_all[k] = ok
                self._lap("bary_enqueue")
            self._mark("bary.end")
        return ys_all, ok_all.all(), overrides

    def _bary_pipe(self, settings, ctx, width: int) -> _BaryChunks:
        cache = settings._device_cache
        key = ("bary_chunks", str(self.device), width)
        if key not in cache:
            cache[key] = _BaryChunks(ctx, self.device, width, settings.preset.field_elements_per_blob)
        return cache[key]

    def _blob_bytes_np(self, settings, blobs):
        """Blob bytes -> host uint8 [n_blobs, fe, 32] (BE field elements).
        Canonicality is checked on the card."""
        fe = settings.preset.field_elements_per_blob
        buf = bytearray().join(bytes(b) for b in blobs)
        return np.frombuffer(buf, dtype=np.uint8).reshape(len(blobs), fe, 32)

    def _root_index(self, settings) -> dict:
        cache = settings._device_cache
        if "roots_idx" not in cache:
            cache["roots_idx"] = {w: i for i, w in enumerate(settings.roots_of_unity)}
        return cache["roots_idx"]

    @_on_own_device
    def _gen_table(self):
        if "gen_table" not in self._ctx:
            from ..ops import verify_kernels as V

            self._ctx["gen_table"] = V.build_generator_table(self.device)
        return self._ctx["gen_table"]

    def _fr_ctx(self, settings, device=None):
        """The Fr context on ``device`` (this backend's card by default)."""
        device = self.device if device is None else torch.device(device)
        cache = settings._device_cache
        key = ("fr_ctx", str(device))
        if key not in cache:
            from ..ops import protocol_kernels as pk

            with on_device(device):
                cache[key] = pk.FrContext.build(settings, device)
        return cache[key]

    def _fr_domain_ctx(self, settings, mesh):
        """The Fr context split over a domain mesh, per settings and mesh."""
        cache = settings._device_cache
        key = ("fr_ctx_domain",) + tuple(str(d) for d in mesh)
        if key not in cache:
            from ..parallel import sharded as S

            cache[key] = S.ShardedFrContext.build(settings, mesh)
        return cache[key]

    # -- prover (device pipelines) --------------------------------------------

    @_on_own_device
    def _msm_ctx(self, settings):
        """Per-settings GLV table, built at the first use: split over a
        point mesh (:meth:`_points_mesh`) where there is one, else on this
        device; None below 8 points (the reference goes naive there,
        utils.rs:369-371)."""
        n = settings.preset.field_elements_per_blob
        mesh = self._points_mesh(n) if n >= 8 else None
        cache = settings._device_cache
        key = ("msm",) + tuple(str(d) for d in (mesh or [self.device]))
        if key not in cache:
            from ..ops import msm as M
            from ..parallel import sharded as S

            if n < 8:
                cache[key] = None
            elif mesh is not None:
                cache[key] = S.ShardedMsmContext.build(settings, mesh)
            else:
                cache[key] = M.MsmContext.build(settings, self.device)
        return cache[key]

    def _blob_dev(self, settings, blob, device=None):
        """One blob's bytes -> [n, 32] uint8 on ``device`` (this backend's by
        default); BadArgs on a wrong length."""
        if len(blob) != settings.preset.bytes_per_blob:
            raise BadArgs(MSG_BLOB_LENGTH)
        arr = np.frombuffer(bytearray(bytes(blob)), dtype=np.uint8).reshape(-1, 32)
        return torch.from_numpy(arr).to(self.device if device is None else device)

    def _fetch(self, *parts):
        """One device-to-host copy of the int32 words of ``parts``."""
        packed = torch.cat([p.reshape(-1).to(torch.int32) for p in parts])
        return packed.cpu().numpy()

    def _prover_mode(self, settings) -> str:
        """``KZG_TORCH_PROVER`` resolved for one prover call, ``device`` or
        ``host``: ``auto`` by the measured rule at one blob, whose bytes
        cross the link (the JAX backend's ``_prover_mode``)."""
        host = self._host_ctx(
            "KZG_TORCH_PROVER",
            self._prover_native_ctx,
            settings,
            lambda: self._auto_prefers_device(settings, 1, settings.preset.bytes_per_blob, "prover"),
        )
        return "device" if host is None else "host"

    def _prover_host(self, settings, blob):
        """The engine's prover context where the call is placed on the host
        (the blob's length checked), None for the device."""
        if self._prover_mode(settings) == "device":
            return None
        if len(blob) != settings.preset.bytes_per_blob:
            raise BadArgs(MSG_BLOB_LENGTH)
        return self._prover_native_ctx(settings)

    @_on_own_device
    def blob_to_commitment_pipeline(self, settings, blob):
        """``blob_to_kzg_commitment`` (reference: kzg.rs:396-406) as one
        device sequence (ingest, canonicality, M1, M2) and one
        fetch of the point and the flag; one engine call with
        ``KZG_TORCH_PROVER=host``."""
        from ..ops import curve as C
        from ..ops import prover_kernels as PR

        from ..parallel import sharded as S

        host = self._prover_host(settings, blob)
        if host is not None:
            return host.commit(bytes(blob))
        ctx = self._msm_ctx(settings)
        if ctx is None:
            return NotImplemented
        self._start_timing()
        if isinstance(ctx, S.ShardedMsmContext):
            # The blob's element axis is the point axis: it splits with the table.
            point, ok = S.sharded_commit(ctx, self._blob_dev(settings, blob, "cpu"))
            arr = self._fetch(point, ok)
            if not arr[-1]:
                raise BadArgs(MSG_INVALID_BYTES32)
            return C.proj_to_points(arr[:-1].reshape(1, 3, -1))[0]
        blob_dev = self._blob_dev(settings, blob)
        self._lap("upload")
        point, ok = PR.commit(ctx, blob_dev, self._mark)
        self._lap("enqueue")
        arr = self._fetch(point, ok)
        self._lap("fetch_wait")
        if not arr[-1]:
            raise BadArgs(MSG_INVALID_BYTES32)
        return C.proj_to_points(arr[:-1].reshape(1, 3, -1))[0]

    @_on_own_device
    def compute_kzg_proof_pipeline(self, settings, blob, z: int):
        """``compute_kzg_proof_impl`` (reference: kzg.rs:461-528) as one
        device sequence (ingest, y, quotient, M1, M2) and one fetch
        of the proof point, y and the flag.  Whether z is a root of the
        domain is decided here on the host.  One engine call with
        ``KZG_TORCH_PROVER=host``."""
        from ..ops import curve as C
        from ..ops import limbs as L
        from ..ops import prover_kernels as PR
        from ..ops.limbs import FR

        from ..parallel import sharded as S

        host = self._prover_host(settings, blob)
        if host is not None:
            return host.prove(bytes(blob), z.to_bytes(32, "big"))
        ctx = self._msm_ctx(settings)
        if ctx is None or isinstance(ctx, S.ShardedMsmContext):
            # On a point mesh the protocol's piecewise path runs: the
            # domain-split evaluation, the quotient here, the split MSM.
            return NotImplemented
        self._start_timing()
        blob_dev = self._blob_dev(settings, blob)
        self._lap("upload")
        m = self._root_index(settings).get(z)
        point, y, ok = PR.proof(self._fr_ctx(settings), ctx, blob_dev, z, m, self._mark)
        self._lap("enqueue")
        arr = self._fetch(point, y, ok)
        self._lap("fetch_wait")
        if not arr[-1]:
            raise BadArgs(MSG_INVALID_BYTES32)
        pw = 3 * L.FP.nwords
        proof_pt = C.proj_to_points(arr[:pw].reshape(1, 3, -1))[0]
        return proof_pt, L.words_to_ints(arr[pw : pw + FR.nwords].reshape(1, -1))[0]

    @_on_own_device
    def compute_blob_proof_pipeline(self, settings, blob, commitment_bytes):
        """``compute_blob_kzg_proof`` (reference: kzg.rs:533-544) as one
        engine call with ``KZG_TORCH_PROVER=host``: commitment validation,
        challenge, quotient and MSM.  NotImplemented on the device, where the
        protocol validates and hashes on the host and then runs
        :meth:`compute_kzg_proof_pipeline`."""
        host = self._prover_host(settings, blob)
        if host is None:
            return NotImplemented
        if len(bytes(commitment_bytes)) != 48:
            raise BadArgs(MSG_EXPECT_48)
        return host.blob_proof(bytes(blob), bytes(commitment_bytes))

    @_on_own_device
    def msm_g1_lagrange(self, settings, scalars):
        from ..ops import msm as M
        from ..parallel import sharded as S

        ctx = self._msm_ctx(settings)
        if ctx is None:  # tiny presets take the host path
            return super().msm_g1_lagrange(settings, scalars)
        if isinstance(ctx, S.ShardedMsmContext):
            return S.msm_fixed_base_sharded(ctx, scalars)
        return M.msm_fixed_base(ctx, scalars)

    # -- polynomial math (device) ---------------------------------------------

    def _fr_words(self, values):
        from ..ops import limbs as L

        return L.to_device(L.FR, values, self.device)

    @_on_own_device
    def barycentric_eval(self, settings, evals, x: int) -> int:
        from ..ops import limbs as L
        from ..ops import protocol_kernels as pk

        mesh = self._domain_mesh(settings.preset.field_elements_per_blob)
        if mesh is not None:
            # The domain split over the mesh's cards: each sums its terms,
            # the Fr partials are added on this card.
            from ..parallel import sharded as S

            ctx = self._fr_domain_ctx(settings, mesh)
            evals_host = torch.from_numpy(L.ints_to_words(L.FR.nwords, evals))[:, None]
            xs_host = torch.from_numpy(L.ints_to_words(L.FR.nwords, [x]))
            return L.words_to_ints(S.sharded_bary(ctx, evals_host, xs_host).cpu())[0]
        y = pk.barycentric_eval(self._fr_ctx(settings), self._fr_words(evals), self._fr_words([x])[0])
        return L.words_to_ints(y[None].cpu())[0]

    @_on_own_device
    def quotient_out_of_domain(self, settings, evals, z: int, y: int):
        from ..ops import limbs as L
        from ..ops import protocol_kernels as pk

        zy = self._fr_words([z, y])
        q = pk.quotient_out_of_domain(self._fr_ctx(settings), self._fr_words(evals), zy[0], zy[1])
        return L.words_to_ints(q.cpu())

    @_on_own_device
    def quotient_in_domain(self, settings, evals, z: int, y: int, m: int):
        from ..ops import limbs as L
        from ..ops import protocol_kernels as pk

        zy = self._fr_words([z, y])
        q = pk.quotient_in_domain(self._fr_ctx(settings), self._fr_words(evals), zy[0], zy[1], m)
        return L.words_to_ints(q.cpu())
