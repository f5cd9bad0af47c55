"""A dry run of the harness on the CPU at the minimal preset: a throwaway
cell added as files only is found by name, driven through the port's
public entry with ``TorchBackend(device="cpu")``, and comes out correct,
with the contract's keys."""

import time

import pytest

from kzgbench import harness


@pytest.mark.parametrize("cell,metrics", [("min.verify", {"verify_call_p95_ms", "setup_s"}), ("min.tx", {"prove_blobs_per_s", "prove_tx_p95_ms", "setup_s"})])
def test_dry_run_is_correct(minimal_root, cell, metrics):
    root = minimal_root()
    r = harness.run(cell, 3_000_000_001, 0.5, False, time.perf_counter(), device="cpu", root=root, reference_workers=2)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == metrics and all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks" and all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    # set-up is every step to the window's start but the reference's making of the pool
    parts = r["setup_parts_s"]
    assert r["metrics"]["setup_s"]["value"] == pytest.approx(sum(v for k, v in parts.items() if k != "pool_made_by_reference"))


def test_traced_dry_run_reads_the_trace(minimal_root):
    root = minimal_root()
    r = harness.run("min.tx", 3_000_000_002, 0.5, True, time.perf_counter(), device="cpu", root=root, reference_workers=2)
    assert r["correct"] is True
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    # the CPU run has no device events, so no device metric is read
    assert not any(name.startswith(("device.", "kernels.")) for name in r["metrics"])
