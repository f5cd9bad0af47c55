"""The 95th percentile of one verification call's latency over every call
of the window (host clock, from the call to its return)."""

import numpy as np

UNIT = "ms"


def read(run):
    if run.api != "verify_blob_kzg_proof_batch":
        return None
    return float(np.percentile([(c.t1 - c.t0) * 1e3 for c in run.calls], 95))
