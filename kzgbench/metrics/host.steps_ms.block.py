"""Host ms of a block's verification call in the backend's steps other
than the pairing (packing and upload, the stages' enqueueing, the
challenges, the fetch's wait, the RLC scalars): every ``host_ms`` lap but
``pairing``, per call."""

UNIT = "ms"


def read(run):
    if "verify_call_p95_ms" not in run.end_to_end:
        return None
    return run.laps_per_call(exclude=("pairing",))
