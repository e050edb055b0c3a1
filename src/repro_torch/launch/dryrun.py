"""Dry run: the shardings of a cell's arguments on the production mesh
(the start of the port of ``repro/launch/dryrun.py``).

Here: :func:`_axis_prod` and :func:`_to_shardings`, which turn a cell's
logical trees (``Cell.arg_logical``) into a ``NamedSharding`` a leaf,
replicating any axis that does not divide its dim.  The reference's
``run_cell`` and ``main``, which lower every cell against 512 faked
devices and record memory, cost and roofline terms, are not ported yet:
their torch form (fake tensors under a fake process group, per-chip
operation counts, H100 constants) is the next slice of the port.
"""
from __future__ import annotations

from repro_torch.distributed import sharding as shd

_axis_prod = shd.axis_prod


def _to_shardings(mesh, logical_tree, spec_tree):
    """Logical tuples -> ``NamedSharding``s, dropping (replicating) any
    axis whose size does not divide the corresponding dim; a leaf that is
    not a tuple of names is replicated."""
    def leaf(names, s):
        if not (isinstance(names, tuple)
                and all(a is None or isinstance(a, str) for a in names)):
            return shd.named(mesh, ())
        return shd.named(mesh, shd.fit(mesh, shd.logical(*names), s.shape))

    return shd.map_specs(leaf, logical_tree, spec_tree)
