"""Wall time of the window outside ``run_batch`` calls (the engine, the
router and the queues on the host) a request completed."""
from perfbench import window


def read(rec):
    n = window.frames(rec)
    return (window.seconds(rec) - window.in_calls_s(rec)) / n * 1e3 if n else None
