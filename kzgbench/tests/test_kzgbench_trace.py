"""The trace's reduction on a made-up Chrome trace: busy time is the union
of the device's intervals inside the window, kernel time their sum, and
each idle gap goes to what the host did at its midpoint."""

import pytest

from kzgbench import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce():
    events = [
        ev("user_annotation", "kzgbench.window", 100, 100),
        ev("user_annotation", "kzgbench.call", 100, 100),
        ev("cpu_op", "aten::copy_", 100, 20),
        ev("kernel", "k1", 110, 20),
        ev("kernel", "k2", 120, 20),  # overlaps k1: busy 110-140
        ev("gpu_memcpy", "Memcpy HtoD", 170, 10),
        ev("cuda_runtime", "cudaGraphLaunch", 150, 10),
        ev("kernel", "outside", 300, 50),
    ]
    s = trace.reduce(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.kernel_s == pytest.approx(40e-6)
    assert s.device_events == 3
    assert dict((n, v) for n, v in s.device_ops) == pytest.approx({"k1": 20e-6, "k2": 20e-6, "Memcpy HtoD": 10e-6})
    gaps = dict((n, v) for n, v in s.idle_gaps)
    # 100-110 under aten::copy_, 140-170 at 155 under cudaGraphLaunch, 180-200 after it
    assert gaps == pytest.approx({"aten::copy_": 10e-6, "cudaGraphLaunch": 30e-6, "python after cudaGraphLaunch": 20e-6})


def test_no_window_no_summary():
    assert trace.reduce([ev("kernel", "k", 0, 1)]).device_events == 0
