"""Wall time of the window inside ``run_batch`` calls (the graphed serve
step: stacking, replay, labels to the host) a request completed."""
from perfbench import window


def read(rec):
    n = window.frames(rec)
    return window.in_calls_s(rec) / n * 1e3 if n else None
