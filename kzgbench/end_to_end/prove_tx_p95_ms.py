"""The 95th percentile of one transaction's commitments and proofs (each
blob's blob_to_kzg_commitment then compute_blob_kzg_proof) over every
transaction of the window (host clock)."""

import numpy as np

UNIT = "ms"


def read(run):
    if run.api != "blob_tx":
        return None
    return float(np.percentile([(c.t1 - c.t0) * 1e3 for c in run.calls], 95))
