"""The device trace of a traced run, reduced to a summary.

A fixed number of steady calls run under ``torch.profiler`` (CPU and CUDA
activities) inside one ``kzgbench.window`` annotation.  The Chrome trace is
written to the run's temporary directory, read and deleted: only this
summary is kept.  Its arithmetic is ``chip_smoke.py``'s ``profile_batch``:
the device's busy time is the union of its kernel, copy and fill
intervals within the window.  Each idle gap of the device is put to what
the host did at the gap's midpoint: the innermost torch operation or CUDA
runtime call there, or the program's Python after the last one.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "kzgbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0
    device_events: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


@contextlib.contextmanager
def profiled(device):
    """Profile the block; yields a list that holds the profile once the
    block has ended (for :func:`summarize`).  The block's device work is
    synchronised at both ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out = []
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    with profile(activities=activities) as prof:
        sync()
        with record_function(WINDOW):
            yield out
            sync()
    out.append(prof)


def summarize(prof) -> Summary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    return reduce(events)


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top(totals: dict, n: int = 10) -> list:
    return [[name[:NAME_CHARS], us / 1e6] for name, us in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def _host_at(host: list, starts: list, t: float) -> str:
    """What the host did at time t: the innermost event that covers it (of
    those that do, the one that started last: the events of one thread
    nest); where that is the harness's own annotation of the call, the
    host ran Python of the program between traced events, named by the
    last event that ended before t."""
    i = bisect.bisect_right(starts, t) - 1
    inner = next((host[j] for j in range(i, -1, -1) if host[j][1] >= t), None)
    if inner is not None and not inner[2].startswith("kzgbench."):
        return inner[2]
    before = max((h for h in host[max(0, i - 256) : i + 1] if h[1] < t and not h[2].startswith("kzgbench.")), key=lambda h: h[1], default=None)
    return f"python after {before[2]}" if before else "python"


def reduce(events: list) -> Summary:
    """Chrome-trace complete events (``ph`` X, times in microseconds) to a
    Summary of the annotated window."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        return Summary()
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    clip = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                clip.append((e["cat"], e["name"], a, b))
    busy = _merged([(a, b) for _, _, a, b in clip])
    by_name: dict[str, float] = {}
    for _, name, a, b in clip:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    # by start, and at one start the outer event first
    host = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
        key=lambda h: (h[0], -h[1]),
    )
    starts = [h[0] for h in host]
    by_host: dict[str, float] = {}
    for a, b in gaps:
        name = _host_at(host, starts, (a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    return Summary(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=sum(b - a for cat, _, a, b in clip if cat == "kernel") / 1e6,
        device_events=len(clip),
        device_ops=_top(by_name),
        idle_gaps=_top(by_host),
    )
