"""One module a kind of system: ``run(...)`` sets a cell up, serves its
traffic for the window, reads the profiled slice where asked, and checks
the timed path's output against the plain reference."""
