"""Measured ``auto`` placement: the cost model behind ``KZG_TORCH_EVAL=auto``
and ``KZG_TORCH_PROVER=auto``.

Counterpart of the JAX package's ``jax_backend.py`` profiles
(``link_profile``, ``host_verify_profile``, ``host_prove_profile``,
``device_verify_profile``, ``device_est``).  ``TorchBackend`` runs a call on
the card exactly when its estimate there beats the measured host engine on
the same call:

    rtt_crossings + upload(n) + device_est(n)        <  host_budget(n)
    rtt_crossings + max(upload(n), device_est(n))    <  host_budget(n)
                       (the unsharded chunked regime: upload overlaps compute)

* the link, by :func:`link_profile`, once per process and card: a fetch's
  round trip, and the rate of one 64-blob chunk (8 MiB) going from
  pageable memory through a pinned buffer to the card on a copy stream,
  the path ``_BaryChunks.stage`` takes;
* the host, by :func:`host_verify_profile` and :func:`host_prove_profile`,
  timing the native engine's ``VerifyCtx`` and ``ProverCtx`` on this
  machine: a blob proof once per process and preset, a batch once per
  process, preset and padded size (the engine spreads a batch over its
  threads, so its time a blob falls with n: on the H100 machine's 8 CPUs
  108 us a blob between 1 and 9 blobs, 65 us at 4096; the JAX package's
  slope over 1 and 9 blobs, extended to n, priced n = 4096 at 442 ms
  against the 267 measured and sent it to a slower card);
* the card, by :func:`device_verify_profile` and :func:`device_est`:
  constants fitted to ``chip_smoke.py`` runs of the device path on an
  H100.  They are not measured in a user's call, which would pay for the
  kernels' nvcc build and the MSM table there; another card overrides them
  with ``KZG_TORCH_DEVICE_FIXED_MS`` and ``KZG_TORCH_DEVICE_PER_BLOB_US``.

Nothing here builds a kernel: the link probe is a torch copy and a torch
add.  Every decision is logged to the port's logger at INFO, once per
(op, n, outcome).
"""

from __future__ import annotations

import os
import random
import threading
import time

from ..utils.observability import logger

# Round trips a device call pays beside its upload (launch, fetch, sync).
AUTO_RTT_CROSSINGS = 2.5

# Host fallbacks, used only where a calibration fails (it runs inside a
# user's first auto-placed call, which must not fail for it): the H100
# machine's engine (8 CPUs) under KZG_TORCH_EVAL=host and
# KZG_TORCH_PROVER=host in two chip_smoke.py runs: 258.8-267.1 ms a batch
# of 4096 blobs, 9.7-12.6 ms a proof (PERF.md section 6).
AUTO_HOST_PER_BLOB_S = 64e-6
AUTO_HOST_PROVE_S = 11e-3
# The largest batch the host calibration times; a larger batch is priced
# at this size's time a blob.
HOST_CALIB_MAX_BLOBS = 1024

# The card's model, seconds: the least-squares line through the device
# path's end-to-end batch times in two chip_smoke.py runs at n = 64 /
# 512 / 4096 (29.9 / 56.3 / 364.3 and 28.0 / 51.4 / 376.8 ms; the auto
# phase prints each run's fit), and a proof's end to end (5.81 and 5.32
# ms), on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6).
AUTO_DEVICE_FIXED_S = 16.98e-3
AUTO_DEVICE_PER_BLOB_S = 86.12e-6
AUTO_DEVICE_PROVE_S = 5.57e-3

FIXED_ENV = "KZG_TORCH_DEVICE_FIXED_MS"
PER_BLOB_ENV = "KZG_TORCH_DEVICE_PER_BLOB_US"

# The link probe: one chunk of the chunked pipeline (BARY_CHUNK_BLOBS
# mainnet blobs of 131,072 bytes).
LINK_PROBE_BYTES = 64 * 131072

# Per-process measurements, keyed by what they depend on: the host's by
# component and bytes_per_blob (a minimal blob verifies in microseconds, so
# presets must not share an entry) and a batch's also by its size;
# ("link", device); ("device_verify", overrides).
_HOST_PROFILE: dict = {}
_HOST_PROFILE_LOCK = threading.Lock()


def _host_profile_cached(key, measure):
    if key not in _HOST_PROFILE:
        with _HOST_PROFILE_LOCK:
            if key not in _HOST_PROFILE:
                _HOST_PROFILE[key] = measure()
    return _HOST_PROFILE[key]


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def link_profile(device) -> tuple[float, float]:
    """``(rtt_seconds, h2d_bytes_per_second)`` of a CUDA ``device``, once per
    process: the round trip is a one-element add fetched to the host (the
    best of 3); the rate is LINK_PROBE_BYTES copied from pageable memory
    into a pinned buffer and uploaded on a copy stream, synchronised (the
    best of 3, after one untimed pass)."""
    import numpy as np
    import torch

    def measure():
        tiny = torch.zeros(8, dtype=torch.int32, device=device)
        (tiny + 1).cpu()
        rtt = min(_timed(lambda: (tiny + 1).cpu()) for _ in range(3))
        pageable = np.random.default_rng(0).integers(0, 256, LINK_PROBE_BYTES, dtype=np.uint8)
        pinned = torch.empty(LINK_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
        landing = torch.empty(LINK_PROBE_BYTES, dtype=torch.uint8, device=device)
        stream = torch.cuda.Stream(device)

        def upload():
            np.copyto(pinned.numpy(), pageable)
            with torch.cuda.stream(stream):
                landing.copy_(pinned, non_blocking=True)
            stream.synchronize()

        upload()
        bw = LINK_PROBE_BYTES / max(min(_timed(upload) for _ in range(3)), 1e-9)
        logger.info("link_profile: rtt=%.3f ms, h2d=%.1f MB/s (%s, %d-byte chunk)", rtt * 1e3, bw / 1e6, device, LINK_PROBE_BYTES)
        return rtt, bw

    return _host_profile_cached(("link", str(device)), measure)


def _calib_blob(bytes_per_blob: int) -> bytes:
    rng = random.Random(0xCA11B)
    return b"".join(b"\x00" + rng.randbytes(31) for _ in range(bytes_per_blob // 32))


def host_verify_profile(verify_ctx, bytes_per_blob: int, n_blobs: int) -> float:
    """Seconds a blob of a batch of ``n_blobs`` takes in the engine's
    ``verify_ctx`` on this machine: a batch of P blobs, P being n_blobs
    padded to a power of two and at most HOST_CALIB_MAX_BLOBS, timed once
    per (process, preset, P) (the best of 2, after one blob), over P.  The
    batch repeats one blob whose points are the generator (they decode and
    pass the subgroup checks; the pairing fails, at the same cost), so
    only pointers cross into the engine.  AUTO_HOST_PER_BLOB_S, with a
    warning, where the calibration fails."""
    p = 1
    while p < min(n_blobs, HOST_CALIB_MAX_BLOBS):
        p *= 2

    def measure():
        try:
            from .. import hostcrypto
            from ..golden import curve as gcurve

            blob = _calib_blob(bytes_per_blob)
            comm = hostcrypto.g1_compress(gcurve.G1_GENERATOR)

            def vb(k: int):
                verify_ctx.verify_scatter([blob] * k, k, comm * k, comm * k)

            vb(1)
            per_blob = max(min(_timed(lambda: vb(p)) for _ in range(2)) / p, 1e-7)
        except Exception:
            logger.warning("host_profile[verify]: calibration failed, fallback per_blob=%.1fus", AUTO_HOST_PER_BLOB_S * 1e6, exc_info=True)
            return AUTO_HOST_PER_BLOB_S
        logger.info("host_profile[verify]: per_blob=%.1fus at %d blobs (measured, blob=%dB)", per_blob * 1e6, p, bytes_per_blob)
        return per_blob

    return _host_profile_cached(("verify", bytes_per_blob, p), measure)


def host_prove_profile(prover_ctx, bytes_per_blob: int) -> float:
    """Seconds a blob proof (``compute_blob_kzg_proof``) takes in the
    engine's ``prover_ctx`` on this machine, the best of 2, once per
    (process, preset); AUTO_HOST_PROVE_S, with a warning, where the
    calibration fails."""

    def measure():
        try:
            from .. import hostcrypto

            blob = _calib_blob(bytes_per_blob)
            comm = hostcrypto.g1_compress(prover_ctx.commit(blob))
            prove_s = max(min(_timed(lambda: prover_ctx.blob_proof(blob, comm)) for _ in range(2)), 1e-6)
        except Exception:
            logger.warning("host_profile[prove]: calibration failed, fallback prove=%.1fms", AUTO_HOST_PROVE_S * 1e3, exc_info=True)
            return AUTO_HOST_PROVE_S
        logger.info("host_profile[prove]: prove=%.1fms (measured, blob=%dB)", prove_s * 1e3, bytes_per_blob)
        return prove_s

    return _host_profile_cached(("prove", bytes_per_blob), measure)


def device_verify_profile() -> tuple[float, float]:
    """The card's batch-verification model ``(fixed_s, per_blob_s)``: the
    H100 constants above, or KZG_TORCH_DEVICE_FIXED_MS and
    KZG_TORCH_DEVICE_PER_BLOB_US where set.  An unparseable override falls
    back to the constants with a warning (once per value)."""
    raw = (os.environ.get(FIXED_ENV), os.environ.get(PER_BLOB_ENV))

    def measure():
        fixed, per_blob = AUTO_DEVICE_FIXED_S, AUTO_DEVICE_PER_BLOB_S
        try:
            if raw[0] is not None:
                fixed = float(raw[0]) * 1e-3
            if raw[1] is not None:
                per_blob = float(raw[1]) * 1e-6
        except ValueError:
            logger.warning("device_profile: unparseable %s=%r / %s=%r, using the H100 model", FIXED_ENV, raw[0], PER_BLOB_ENV, raw[1])
            fixed, per_blob = AUTO_DEVICE_FIXED_S, AUTO_DEVICE_PER_BLOB_S
        overridden = (fixed, per_blob) != (AUTO_DEVICE_FIXED_S, AUTO_DEVICE_PER_BLOB_S)
        logger.info("device_profile[verify]: fixed=%.2fms per_blob=%.2fus%s", fixed * 1e3, per_blob * 1e6, " (env override)" if overridden else "")
        return fixed, per_blob

    return _host_profile_cached(("device_verify",) + raw, measure)


def device_est(n_blobs: int, op: str) -> float:
    """Estimated seconds of the card's work for ``op`` (``verify_batch`` or
    ``prover``) at ``n_blobs``."""
    if op == "prover":
        return AUTO_DEVICE_PROVE_S
    fixed, per_blob = device_verify_profile()
    return fixed + n_blobs * per_blob
