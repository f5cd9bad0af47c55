"""The card's idle share of the traced calls' window: 100 less the union
of its kernel, copy and fill intervals over the window (the profiler's
trace), in the cells that report verify_call_p95_ms."""

UNIT = "%"


def read(run):
    if "verify_call_p95_ms" not in run.end_to_end:
        return None
    return run.idle_pct()
