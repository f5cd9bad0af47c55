"""The kernels' share of their roofline in the traced transactions: the
least time for each blob's commitment and proof (``roofline.py``) over all
kernel time the profiler recorded in the transactions."""

from kzgbench import roofline

UNIT = "%"


def read(run):
    if "prove_blobs_per_s" not in run.end_to_end:
        return None
    return run.roofline_pct(lambda c: (roofline.prove_commit(run.fe) + roofline.prove_proof(run.fe)) * c.blobs)
