"""Process start to the first timed request: imports, weights and frames,
the kernels' build (on a cold checkout) and the graphs' capture."""


def read(rec):
    return rec["setup_s"]
