"""The 95th percentile, over every frame completed in the window, of the
wall time from the call into the replica's ``run_batch`` that carries it
to its label on the host."""
import numpy as np

from perfbench import window


def read(rec):
    lat = [b - a for a, b, n, _ in window.counted(rec) for _ in range(n)]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
