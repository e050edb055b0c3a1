"""The share of the serving time in which no operation ran on the device,
in percent: the device's busy seconds in the profiled slice over the
wall time that the slice's episodes took in the window, unprofiled (the
profiler slows the host, not the device's operations)."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["unprofiled_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["unprofiled_s"])
