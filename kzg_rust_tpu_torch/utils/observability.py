"""Structured logging + device-trace hooks.

The reference has no logging or tracing anywhere (SURVEY.md §5 — errors
carry context strings, nothing else).  This module adds the two
observability facilities the device build needs while keeping the library
silent by default:

* a package logger (``kzg_rust_tpu_torch``) with a ``NullHandler`` — nothing is
  emitted unless the host application configures logging, matching the
  reference's "silent library" behavior;
* ``timed(event, **fields)`` — a context manager that logs one structured
  line (event name, wall time, caller-supplied fields) at DEBUG when the
  block exits.  Used around trusted-setup loading and by the benchmark
  CLIs;
* ``device_trace()`` — wraps ``torch.profiler.profile`` when the
  environment variable ``KZG_TORCH_TRACE_DIR`` names a directory, else a
  no-op.  Lets any run capture a host and CUDA profile without code
  changes; the Chrome trace lands in that directory.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger("kzg_rust_tpu_torch")
logger.addHandler(logging.NullHandler())


@contextlib.contextmanager
def timed(event: str, **fields):
    """Log one structured ``event key=value ... wall_ms=N`` line at DEBUG."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        wall_ms = (time.perf_counter() - t0) * 1e3
        if logger.isEnabledFor(logging.DEBUG):
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            logger.debug("%s %s wall_ms=%.2f", event, kv, wall_ms)


@contextlib.contextmanager
def device_trace():
    """Capture a ``torch.profiler`` trace if ``KZG_TORCH_TRACE_DIR`` is set.

    The trace covers every host op and CUDA kernel inside the block and is
    written as a Chrome trace (``trace.json``) into that directory.  No-op
    (zero overhead) when the variable is unset.
    """
    trace_dir = os.environ.get("KZG_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info("device_trace start dir=%s", trace_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    logger.info("device_trace done dir=%s", trace_dir)
