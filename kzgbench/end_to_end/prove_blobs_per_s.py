"""Blobs committed and proved a second: the blobs of every transaction of
the window over the window's seconds (host clock)."""

UNIT = "blobs/s"


def read(run):
    if run.api != "blob_tx":
        return None
    return sum(c.blobs for c in run.calls if not c.crashed) / run.window_s
