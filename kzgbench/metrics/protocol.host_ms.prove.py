"""Host ms a blob spends in the protocol layer (``protocol.py``, ``api.py``)
outside the backend's device pipeline: each prover call's span on the
harness's clock less the backend's laps of it, summed over a blob's
commitment and proof, per blob."""

UNIT = "ms"


def read(run):
    if "prove_blobs_per_s" not in run.end_to_end:
        return None
    calls = run.lap_calls
    if not calls:
        return None
    outside = sum(span - sum(laps.values()) for c in calls for span, laps in c.spans)
    return outside / sum(c.blobs for c in calls)
