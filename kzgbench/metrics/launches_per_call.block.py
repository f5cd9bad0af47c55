"""Kernel launches a block's verification call makes, by the program's
counter (``ops/_build.LAUNCHES``; a graph replay counts one), over the
untraced calls of a traced run."""

UNIT = "launches"


def read(run):
    if "verify_call_p95_ms" not in run.end_to_end:
        return None
    calls = [c for c in run.calls[len(run.traced) :] if c.launches is not None]
    return sum(c.launches for c in calls) / len(calls) if calls else None
