"""The control of ``correct``: the reference, with one guarantee of the
configuration broken, put in the program's place, and judged by the same
comparison as a run.

* Verification: the subgroup check of the points left out (the step that
  would tempt a faster verifier).  It must fail the off-subgroup faults.
* The prover: a Fiat-Shamir challenge that leaves the commitment out, so
  the proof no longer binds it.  It must fail every blob, and every batch
  the reference verifies.

For each seed it makes the cell's traffic as a run does, takes the first
``--calls`` calls (as many as a run completes at the benchmark's window),
answers them with the control, and prints the comparison's numbers; a
control that comes out ``correct`` is a comparison that cannot fail.  The
benchmark's runs never run it.

    python3 kzgbench/control.py --workload <cell> --calls <k> --seeds <s> [<s> ...]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kzgbench import check, generator, harness, pool, workers  # noqa: E402


def control_run(workload: str, seed: int, calls: int, root: str = harness.BENCH, reference_workers: int | None = None) -> dict:
    """The comparison's numbers for the control on ``calls`` calls of the
    cell's traffic from ``seed``."""
    _, cfg, mix = harness.load_cell(workload, root)
    fe = int(cfg["FIELD_ELEMENTS_PER_BLOB"])
    setup_path = os.path.join(root, cfg["trusted_setup"])
    api = mix["api"]
    triples, pool_path = None, None
    make = lambda: workers.executor(setup_path, fe, pool_path, reference_workers)  # noqa: E731
    if api in generator.VERIFY_APIS:
        pool_path = pool.path_for(os.path.join(harness.CACHE, "pool"), cfg, setup_path, mix["pool_seed"], mix["pool_size"])
        triples = pool.load_or_make(pool_path, fe, mix["pool_seed"], mix["pool_size"], lambda: workers.executor(setup_path, fe, None, reference_workers))
    traffic = generator.traffic(mix, cfg, seed, triples, generator.last_level_cache_bytes())
    made = [traffic.call(k) for k in range(calls)]
    records = [harness.CallRecord(0.0, c.blobs, c.expect, c.lanes, c.fault) for c in made]
    with make() as ex:
        if api == "blob_tx":
            sample = traffic.sample(records, int(mix["reference_blobs"]))
            batches = harness.verify_batches(traffic, records, mix)
            # the control's outputs at every blob either comparison reads
            wanted = sorted(set(sample).union(*batches))
            blobs = [made[k].args[0][j] for k, j in wanted]
            for (k, j), out in zip(wanted, ex.map(workers.prove, blobs, [False] * len(blobs))):
                records[k].outputs += [None] * (j + 1 - len(records[k].outputs))
                records[k].outputs[j] = out
            for r in records:
                r.outcome = True
            answers = ex.map(workers.prove, [made[k].args[0][j] for k, j in sample])
            verdicts = ex.map(workers.verify_outputs, [harness.output_triples(traffic, records, b) for b in batches])
            numbers = check.prove_numbers(records, sample, list(answers), batches, list(verdicts))
        else:
            descs = [{"lanes": c.lanes, "fault": c.fault} for c in made]
            for r, out in zip(records, ex.map(workers.verify, descs, [False] * len(descs))):
                r.outcome = out
            sample = traffic.sample(records, mix["reference_valid_calls"])
            answers = list(ex.map(workers.verify, [descs[k] for k in sample]))
            numbers = check.verify_numbers(records, sample, answers)
    return {"workload": workload, "seed": seed, "calls": calls, "correct": check.passed(numbers), "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
