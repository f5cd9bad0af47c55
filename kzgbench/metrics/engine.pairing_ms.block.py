"""Host ms of a block's verification call in the host engine's pairing
(``hostcrypto`` over ``native/``): the ``pairing`` lap, per call."""

UNIT = "ms"


def read(run):
    if "verify_call_p95_ms" not in run.end_to_end:
        return None
    return run.laps_per_call(("pairing",))
