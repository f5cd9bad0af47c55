"""Host ms a blob's commitment and proof wait on the card for their one
fetch each: the backend's ``fetch_wait`` laps, per blob."""

UNIT = "ms"


def read(run):
    if "prove_blobs_per_s" not in run.end_to_end:
        return None
    return run.laps_per_call(("fetch_wait",), per_blob=True)
