"""The kernels' share of their roofline in the traced verification calls:
the least time for the work the calls' real lanes need (``roofline.py``,
stage by stage; a call refused at the flags' fetch runs no stage 2) over
all kernel time the profiler recorded in the calls."""

from kzgbench import roofline

UNIT = "%"
ERRORS = ("invalid_g1", "not_in_subgroup", "non_canonical")


def read(run):
    if "verify_call_p95_ms" not in run.end_to_end:
        return None
    return run.roofline_pct(lambda c: roofline.verify_call(c.blobs, run.fe, stage2=c.outcome not in ERRORS))
