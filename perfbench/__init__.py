"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

Run one cell from the root of a checkout::

    python3 -m perfbench.run --workload deit_b.surveillance_peak \\
        --seed 1234 --seconds 30 --trace 0

The harness is driven by data.  ``BENCHMARK.json`` at the checkout's root
names the cells, configurations and metrics; everything that belongs to
one of them sits in files of its own, found by that name:

* ``configs/<config>.json``: a configuration as it is run (source, widths,
  dtype, ``reduced``, and the ``driver`` of its kind of system);
* ``traffic/<mix>.json``: a traffic mix, the parameters that the general
  generator of its driver reads;
* ``checks/<cell>.json``: the limits of the cell's correctness check;
* ``drivers/<driver>.py``: sets a cell up, serves its traffic for the
  window, and checks what the timed path produced against the plain
  reference; it returns the run's record;
* ``metrics/<metric>.py``: one metric's reader, ``read(record)``, which
  returns a number or ``None`` where it finds nothing to read.

A later cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``: no file here needs an edit.

The yardstick is frozen here, apart from the program: the traffic
generator (:mod:`perfbench.traffic`), the H100's peaks
(:mod:`perfbench.peaks`), the operations and bytes of the work
(:mod:`perfbench.counts`), the weights and frames
(:mod:`perfbench.inputs`), the plain references (``reference/``) and the
comparison that decides ``correct``.  Nothing here imports ``jax`` or the
JAX package ``repro``; the drivers import ``repro_torch`` inside their
functions.
"""
