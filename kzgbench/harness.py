"""One run of one cell: set-up, the measured window, the check, the
metrics.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``);
:mod:`.generator` makes the mix's calls from the seed.  The program runs
through its public entry, ``kzg_rust_tpu_torch.api.Kzg``, with its default
backend on the card (``TorchBackend``, placement ``device``), and with
``TorchBackend(time_stages=True)`` in a traced run, whose first
``trace_calls`` calls run under the profiler (:mod:`.trace`).

The window is a closed loop with one caller: the next call starts when the
last returns, for ``--seconds`` seconds and then to the end of the call
under way.  The metrics are files of their own, found by name:
``end_to_end/<metric>.py`` (those the mix lists, without ``--trace``) and
``metrics/<metric>.py`` (every one that finds something to read, with
``--trace 1``); each has ``UNIT`` and ``read(run) -> float | None``.
"""

from __future__ import annotations

import gc
import glob
import importlib.util
import json
import os
import subprocess
import time
from dataclasses import dataclass, field

import numpy as np

from . import check, generator, pool, roofline, workers
from . import trace as tracing

BENCH = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(BENCH, ".cache")


def load(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, f"{name}.json")) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = BENCH) -> tuple[dict, dict, dict]:
    """(workload, configuration, mix) of cell ``name``."""
    wl = load(root, "workloads", name)
    return wl, load(root, "configs", wl["config"]), load(root, "traffic", wl["traffic"])


def readers(kind: str) -> dict:
    """name -> module of every metric reader in ``kind/``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH, kind, "*.py"))):
        name = os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location(f"kzgbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


@dataclass
class CallRecord:
    """One call of the window as the caller saw it: host-clock start and
    end, its outcome (True / False, the kind of error the program raised,
    or ``crash: ...`` for an exception the specs do not raise), the
    prover's output bytes, each API call's span (ms) with the backend's
    host laps of it, and the launches it made (traced runs)."""

    t0: float
    blobs: int
    expect: object = None
    lanes: list = field(default_factory=list)
    fault: dict | None = None
    t1: float = 0.0
    outcome: object = None
    outputs: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    launches: int | None = None

    @property
    def crashed(self) -> bool:
        return isinstance(self.outcome, str) and self.outcome.startswith("crash")


@dataclass
class Run:
    """What the readers read."""

    api: str
    end_to_end: tuple
    fe: int
    calls: list
    window_s: float
    traced: list
    trace: tracing.Summary | None
    sm_clock_hz: float
    sms: int

    @property
    def lap_calls(self) -> list:
        """The window's calls outside the profiler, with their laps."""
        return [c for c in self.calls[len(self.traced) :] if any(laps for _, laps in c.spans)]

    def laps_per_call(self, steps=None, per_blob: bool = False, exclude=()) -> float | None:
        """Host ms of the backend's laps named in ``steps`` (None: every
        lap but those in ``exclude``), summed over the untraced calls, per
        call or per blob; None where no such lap was recorded."""
        calls = self.lap_calls
        found, total = False, 0.0
        for c in calls:
            for _, laps in c.spans:
                for step, ms in laps.items():
                    if (step in steps) if steps is not None else step not in exclude:
                        found, total = True, total + ms
        if not found:
            return None
        return total / (sum(c.blobs for c in calls) if per_blob else len(calls))

    def roofline_pct(self, work_of) -> float | None:
        """100 x the least time of the traced calls' counted work
        (``work_of(call)``) over the trace's kernel time."""
        if self.trace is None or self.trace.kernel_s <= 0:
            return None
        least = sum(roofline.bound_s(work_of(c), self.sm_clock_hz, self.sms) for c in self.traced)
        return 100.0 * least / self.trace.kernel_s

    def idle_pct(self) -> float | None:
        if self.trace is None or self.trace.window_s <= 0 or self.trace.device_events == 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def card_info(device) -> dict:
    """The card's name, power limit and maximum SM clock from nvidia-smi,
    and its SM count; the data sheet's H100 clock and count where none
    are read."""
    import torch

    info = {"kind": torch.cuda.get_device_name(device), "sms": torch.cuda.get_device_properties(device).multi_processor_count}
    info["power_limit_w"], info["sm_clock_max_mhz"] = None, roofline.H100_MAX_SM_CLOCK_HZ / 1e6
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=power.limit,clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.split(",")
        info["power_limit_w"], info["sm_clock_max_mhz"] = float(out[0]), float(out[1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


def _caller(api: str, settings, backend, timed: bool):
    """The function that makes one call of the window and returns its
    CallRecord."""
    from kzg_rust_tpu_torch import Kzg, KzgError
    from kzg_rust_tpu_torch.ops import _build

    def laps():
        laps_ = dict(backend.host_ms) if timed else {}
        backend.host_ms = {}
        return laps_

    def launched():
        return sum(_build.LAUNCHES.values())

    def verify(call) -> CallRecord:
        rec = CallRecord(time.perf_counter(), call.blobs, call.expect, call.lanes, call.fault)
        n0 = launched() if timed else None
        try:
            rec.outcome = bool(Kzg.verify_blob_kzg_proof_batch(*call.args, settings, backend))
        except KzgError as e:
            rec.outcome = check.error_kind(str(e))
        except Exception as e:  # a crash is a result to report, not to stop on
            rec.outcome = f"crash: {type(e).__name__}: {e}"
        rec.t1 = time.perf_counter()
        rec.spans.append(((rec.t1 - rec.t0) * 1e3, laps()))
        rec.launches = launched() - n0 if timed else None
        return rec

    def blob_tx(call) -> CallRecord:
        rec = CallRecord(time.perf_counter(), call.blobs)
        n0 = launched() if timed else None
        try:
            for blob in call.args[0]:
                t = time.perf_counter()
                c = Kzg.blob_to_kzg_commitment(blob, settings, backend)
                t_c = time.perf_counter()
                rec.spans.append(((t_c - t) * 1e3, laps()))
                p = Kzg.compute_blob_kzg_proof(blob, c, settings, backend)
                rec.spans.append(((time.perf_counter() - t_c) * 1e3, laps()))
                rec.outputs.append((bytes(c), bytes(p)))
            rec.outcome = True
        except Exception as e:  # a crash is a result to report, not to stop on
            rec.outcome = f"crash: {type(e).__name__}: {e}"
        rec.t1 = time.perf_counter()
        rec.launches = launched() - n0 if timed else None
        return rec

    return blob_tx if api == "blob_tx" else verify


def verify_batches(traffic, calls: list, mix: dict) -> list[list[tuple[int, int]]]:
    """The (call, blob) pairs whose outputs the reference verifies, drawn
    from the seed, in batches of ``reference_verify_batch``."""
    pairs = traffic.verify_sample(calls, int(mix["reference_verify_blobs"]))
    size = int(mix["reference_verify_batch"])
    return [pairs[i : i + size] for i in range(0, len(pairs), size)]


def output_triples(traffic, calls: list, batch: list[tuple[int, int]]) -> list[tuple[bytes, bytes, bytes]]:
    """Each pair's blob with the commitment and proof the program gave it
    (empty bytes where it gave none, which the reference refuses)."""
    return [(traffic.call(k).args[0][j], *(check.output(calls, k, j) or (b"", b""))) for k, j in batch]


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float, device=None, root: str = BENCH, reference_workers: int | None = None) -> dict:
    """One run; returns the result line's object (the harness's module
    check and printing are the caller's)."""
    import torch

    from kzg_rust_tpu_torch import PRESETS, Kzg
    from kzg_rust_tpu_torch.backends.torch_backend import TorchBackend

    wl, cfg, mix = load_cell(workload, root)
    fe = int(cfg["FIELD_ELEMENTS_PER_BLOB"])
    preset = PRESETS[cfg["preset"]]
    if preset.field_elements_per_blob != fe:
        raise ValueError(f"{cfg['name']}: preset {preset.name} has {preset.field_elements_per_blob} elements a blob, the file {fe}")
    setup_path = os.path.join(root, cfg["trusted_setup"])
    api = mix["api"]

    parts, t = {}, t_start

    def part(name):
        nonlocal t
        now = time.perf_counter()
        parts[name] = now - t
        t = now

    part("imports")
    settings = Kzg.load_trusted_setup_file(setup_path, preset)
    part("trusted_setup")
    backend = TorchBackend(device=device, time_stages=trace)
    part("backend")
    dev = backend.device
    cuda = dev.type == "cuda"
    llc = generator.last_level_cache_bytes()
    triples, pool_path = None, None
    if api in generator.VERIFY_APIS:
        pool_path = pool.path_for(os.path.join(CACHE, "pool"), cfg, setup_path, mix["pool_seed"], mix["pool_size"])
        made = not pool.cached(pool_path, fe, mix["pool_size"])
        triples = pool.load_or_make(
            pool_path, fe, mix["pool_seed"], mix["pool_size"],
            lambda: workers.executor(setup_path, fe, None, reference_workers),
        )
        part("pool_made_by_reference" if made else "pool")
    traffic = generator.traffic(mix, cfg, seed, triples, llc)
    part("traffic")
    do = _caller(api, settings, backend, trace)
    for call in traffic.warmup(int(mix["warmup_calls"])):
        do(call)
    if cuda:
        torch.cuda.synchronize(dev)
    part("warmup")
    # The reference's making of the pool (once a checkout) is the
    # yardstick's work, not the program's set-up.
    setup_s = t - t_start - parts.get("pool_made_by_reference", 0.0)

    calls, prof = [], None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if trace:
        with tracing.profiled(dev) as holder:
            for k in range(int(mix["trace_calls"])):
                with torch.profiler.record_function("kzgbench.call"):
                    calls.append(do(traffic.call(k)))
        prof = holder[0]
    traced = list(calls)
    while not calls or len(calls) == len(traced) or time.perf_counter() < deadline:
        calls.append(do(traffic.call(len(calls))))
    window_s = calls[-1].t1 - t0

    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    info = card_info(dev) if cuda else {"kind": "cpu", "sms": roofline.H100_SMS, "power_limit_w": None, "sm_clock_max_mhz": roofline.H100_MAX_SM_CLOCK_HZ / 1e6}
    summary = tracing.summarize(prof) if prof is not None else None
    del backend, settings, do, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The check, in the reference's processes, once the program's state is freed.
    t_check = time.perf_counter()
    with workers.executor(setup_path, fe, pool_path, reference_workers) as ex:
        if api == "blob_tx":
            sample = traffic.sample(calls, int(mix["reference_blobs"]))
            batches = verify_batches(traffic, calls, mix)
            proved = ex.map(workers.prove, [traffic.call(k).args[0][j] for k, j in sample])
            verdicts = ex.map(workers.verify_outputs, [output_triples(traffic, calls, b) for b in batches])
            numbers = check.prove_numbers(calls, sample, list(proved), batches, list(verdicts))
            checked = len(sample) + sum(map(len, batches))
        else:
            sample = traffic.sample(calls, mix["reference_valid_calls"])
            answers = list(ex.map(workers.verify, [{"lanes": calls[k].lanes, "fault": calls[k].fault} for k in sample]))
            numbers = check.verify_numbers(calls, sample, answers)
            checked = len(sample)
    check_s = time.perf_counter() - t_check

    view = Run(api, tuple(mix["end_to_end"]), fe, calls, window_s, traced, summary, info["sm_clock_max_mhz"] * 1e6, info["sms"])
    metrics = {}
    if trace:
        for name, mod in readers("metrics").items():
            value = mod.read(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        found = readers("end_to_end")
        for name in mix["end_to_end"]:
            metrics[name] = {"value": found[name].read(view), "unit": found[name].UNIT}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": info["kind"],
        "count": 1,
        "memory_peak_bytes": peak,
        "power_limit_w": info["power_limit_w"],
        "sm_clock_max_mhz": info["sm_clock_max_mhz"],
        "llc_bytes": llc,
        "ring_bytes": traffic.ring_bytes,
    }
    result = {
        "correct": check.passed(numbers),
        "attempted": len(calls),
        "failed": sum(1 for c in calls if c.crashed or (c.expect is not None and c.outcome != c.expect)),
        "metrics": metrics,
        "device": device_info,
        "setup_parts_s": parts,
        "check_s": check_s,
        "call_ms_by_tenth": [float(np.median(part)) for part in np.array_split([(c.t1 - c.t0) * 1e3 for c in calls], min(10, len(calls)))],
        "checked": checked,
    }
    if trace:
        tenths = np.array_split(calls[len(traced) :], min(10, len(calls) - len(traced)))
        steps = sorted({s for c in calls for _, laps in c.spans for s in laps})
        result["laps_ms_by_tenth"] = {s: [float(np.mean([sum(l.get(s, 0.0) for _, l in c.spans) for c in part])) for part in tenths] for s in steps}
    if summary is not None:
        device_info["busy_s"], device_info["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    return result

