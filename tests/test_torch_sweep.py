"""Sweeps: the port's ``repro_torch.fleetsim.simulate_fn`` with a leading
cell axis (on the CPU, the eager loop over the cells one after another)
against the JAX reference's ``simulate_fn`` under ``jax.vmap``.

Two grids of the shape the repo's callers map (``examples/
fleet_sweep.py``: seeds × SLA scales; ``examples/mobility_sweep.py``:
latency × bandwidth), cut to the hot 3-node fleet so each cell is a
second.  Bar: per cell and per request exact on ``outcome``,
``served_by``, ``forwards_used``, ``completion`` and ``transfer_used``
and on every integer aggregate; the stacked telemetry cube's counters and
occupancy exactly, its integrals within ``summary.DERIVED_ATOL``; and
each cell bit for bit equal to the same run through ``simulate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleetsim as jfs
import repro.telemetry as jtel
from repro.orchestration import (Topology as JTopology,
                                 UniformWorkload as JUniformWorkload)
import repro_torch.fleetsim as tfs
import repro_torch.telemetry as ttel
from repro_torch.orchestration import (Topology as TTopology,
                                       UniformWorkload as TUniformWorkload)

HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
PER_REQUEST = ("outcome", "served_by", "forwards_used", "completion",
               "transfer_used")
AGGREGATES = ("total", "processed", "met_deadline", "forwards", "discarded",
              "overflow", "window_saturation", "event_overflow")
FLOATS = ("mean_response_time", "end_time", "transfer_time")
SEEDS, SCALES = [0, 1, 2, 7], [0.7, 1.0]
LATENCY, BANDWIDTH = [0.0, 30.0], [float("inf"), 0.3125]


def _arrays():
    ja, _ = JUniformWorkload(HOT_COUNTS, window=1200.0,
                             name="hot").to_arrays(0)
    ta, _ = TUniformWorkload(HOT_COUNTS, window=1200.0,
                             name="hot").to_arrays(0)
    return ja, ta


def _grid():
    """The (seed, scale) grid flattened seed-major, as numpy."""
    seeds, scales = np.meshgrid(np.asarray(SEEDS, np.int32),
                                np.asarray(SCALES, np.float32),
                                indexing="ij")
    return seeds.ravel(), scales.ravel()


def _nets(NetParams):
    nets = [NetParams.uniform(3, lam, 0.0 if np.isinf(bw) else 1.0 / bw)
            for lam in LATENCY for bw in BANDWIDTH]
    return NetParams(latency=np.stack([n.latency for n in nets]),
                     inv_bw=np.stack([n.inv_bw for n in nets]))


def _assert_cells(a, b, C):
    """The reference's vmapped metrics ``a`` against the port's ``b``."""
    for f in PER_REQUEST:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.shape == y.shape == (C, x.shape[1]) and x.dtype == y.dtype
        assert np.array_equal(x, y), f
    for f in AGGREGATES:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              getattr(b, f).numpy()), f
    for f in FLOATS:
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5)
    assert len(b.events) == len(b.retire_iterations) == C


@pytest.fixture(scope="module")
def seed_grid():
    """A 4-seed × 2-scale grid under ``random`` with telemetry, through
    both packages."""
    ja, ta = _arrays()
    seeds, scales = _grid()
    R = ja.arrival.shape[0]
    cfg = (8, 3000.0)
    run = jfs.simulate_fn(policy="random", capacity=512, depth=256,
                          telemetry=jtel.TelemetryConfig(*cfg))
    a = jax.vmap(run, in_axes=(None, None, jfs.SimParams(0, 0), None))(
        ja, jfs.topology_arrays(JTopology.full_mesh(3)),
        jfs.SimParams(jnp.asarray(seeds), jnp.asarray(scales)),
        jnp.full((R, 2), -1, jnp.int32))
    b = tfs.simulate_fn(policy="random", capacity=512, depth=256,
                        telemetry=ttel.TelemetryConfig(*cfg),
                        device="cpu")(
        ta, tfs.topology_arrays(TTopology.full_mesh(3)),
        tfs.SimParams.make(seeds, scales), None)
    return a, b, ta


def test_seed_grid_matches_vmapped_reference(seed_grid):
    a, b, _ = seed_grid
    _assert_cells(a, b, len(SEEDS) * len(SCALES))
    assert len(set(b.met_deadline.tolist())) > 2      # the cells differ


def test_seed_grid_stacked_cube_matches_reference(seed_grid):
    a, b, _ = seed_grid
    C = len(SEEDS) * len(SCALES)
    fa, fb = a.telemetry, b.telemetry
    assert fb.counts.shape == (C, 3, 8, 5)
    assert fb.occupancy_hwm.shape == (C, 8)
    assert fb.queue_depth.shape == fb.busy_time.shape == (C, 3, 8)
    assert fb.bucket_width.shape == np.asarray(fa.bucket_width).shape == (C,)
    assert np.array_equal(np.asarray(fa.counts), fb.counts.numpy())
    assert np.array_equal(np.asarray(fa.occupancy_hwm),
                          fb.occupancy_hwm.numpy())
    for c in range(C):
        want = ttel.TelemetrySummary.from_frame(ttel.TelemetryFrame(
            *(torch.tensor(np.asarray(t)[c]) for t in fa)))
        agr = ttel.compare_summaries(
            want, ttel.TelemetrySummary.from_frame(fb.cell(c)))
        assert agr.ok, (c, agr.row())


def test_each_cell_equals_its_own_run(seed_grid):
    """Cell c of the sweep is bit for bit the run of its seed and scale
    through ``simulate``, telemetry included."""
    _, b, ta = seed_grid
    seeds, scales = _grid()
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    for c in (0, 5):
        one = tfs.simulate(ta, topo, tfs.SimParams.make(seeds[c], scales[c]),
                           policy="random", capacity=512, depth=256,
                           telemetry=ttel.TelemetryConfig(8, 3000.0),
                           device="cpu")
        cell = b.cell(c)
        for f in PER_REQUEST + AGGREGATES + FLOATS:
            assert torch.equal(getattr(cell, f), getattr(one, f)), (c, f)
        assert (cell.events, cell.retire_iterations) == (
            one.events, one.retire_iterations)
        for x, y in zip(cell.telemetry, one.telemetry):
            assert torch.equal(x, y)


def test_network_grid_matches_vmapped_reference():
    """A 2 × 2 latency × bandwidth grid under ``least_loaded`` (the shape
    of examples/mobility_sweep.py's), the network the cell axis."""
    ja, ta = _arrays()
    R = ja.arrival.shape[0]
    run = jfs.simulate_fn(policy="least_loaded", capacity=256, depth=128,
                          network=True)
    a = jax.vmap(run, in_axes=(None, None, None, None, 0))(
        ja, jfs.topology_arrays(JTopology.full_mesh(3)), jfs.SimParams.make(0),
        jnp.full((R, 2), -1, jnp.int32), _nets(jfs.NetParams))
    b = tfs.simulate_fn(policy="least_loaded", capacity=256, depth=128,
                        network=True, device="cpu")(
        ta, tfs.topology_arrays(TTopology.full_mesh(3)), None, None,
        _nets(tfs.NetParams))
    _assert_cells(a, b, 4)
    assert b.telemetry is None
    assert float(b.transfer_time[0]) == 0.0 < float(b.transfer_time[3])


def test_cell_axis_rules():
    """Scalars broadcast, the axes must agree in length, and ``simulate``
    and ``simulate_fn`` refuse what is not theirs."""
    _, ta = _arrays()
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    run = tfs.simulate_fn(policy="least_loaded", capacity=512, depth=256,
                          device="cpu")
    one = run(ta, topo)
    assert one.total.shape == () and isinstance(one.events, int)
    assert torch.equal(one.served_by, tfs.simulate(
        ta, topo, policy="least_loaded", capacity=512, depth=256,
        device="cpu").served_by)
    two = run(ta, topo, tfs.SimParams(seed=[3, 3], sla_scale=1.0))
    assert two.total.shape == (2,)
    assert torch.equal(two.served_by[0], one.served_by)
    assert torch.equal(two.served_by[1], one.served_by)
    with pytest.raises(ValueError, match="disagree"):
        run(ta, topo, tfs.SimParams.make([0, 1], [1.0, 1.0, 2.0]))
    with pytest.raises(ValueError, match="one leading cell axis"):
        run(ta, topo, tfs.SimParams(seed=np.zeros((2, 2), np.int32)))
    with pytest.raises(ValueError, match="one leading cell axis"):
        tfs.SimParams.make(0, np.ones((2, 1)))
    with pytest.raises(ValueError, match="network=True"):
        tfs.simulate_fn(network=True, device="cpu")(ta, topo)
    with pytest.raises(ValueError, match="takes no net"):
        run(ta, topo, None, None, _nets(tfs.NetParams))
    with pytest.raises(ValueError, match="simulate_fn"):
        tfs.simulate(ta, topo, net=_nets(tfs.NetParams), device="cpu")


def test_network_grid_equals_golden_file():
    """The whole 12-cell latency × bandwidth grid of examples/
    mobility_sweep.py on the CPU against the reference's entries in
    tests/data/torch_fleetsim_golden.json (``sweeps.net_grid``), the
    entries ``chip_smoke.py`` holds the card's one launch to."""
    import hashlib
    import json
    import os
    path = os.path.join(os.path.dirname(__file__), "data",
                        "torch_fleetsim_golden.json")
    with open(path) as f:
        g = json.load(f)["sweeps"]["net_grid"]
    K = len(g["counts"])
    reqs, _ = TUniformWorkload(g["counts"], window=g["window"],
                               name="hot").to_arrays(0)
    nets = [tfs.NetParams.uniform(K, c["latency"], 0.0 if c["bandwidth"] ==
                                  "inf" else 1.0 / c["bandwidth"])
            for c in g["cells"]]
    m = tfs.simulate_fn(policy=g["policy"], capacity=g["capacity"],
                        depth=g["depth"], network=True, device="cpu")(
        reqs, tfs.topology_arrays(TTopology.full_mesh(K)), None, None,
        tfs.NetParams(np.stack([n.latency for n in nets]),
                      np.stack([n.inv_bw for n in nets])))
    digest = lambda t: hashlib.sha256(
        t.numpy().astype(np.int32).tobytes()).hexdigest()
    for c, want in enumerate(g["cells"]):
        cell = m.cell(c)
        for k, v in want["aggregates"].items():
            assert int(getattr(cell, k)) == v, (c, k)
        for k, v in want["digests"].items():
            assert digest(getattr(cell, k)) == v, (c, k)
        for k, v in want["floats"].items():
            assert abs(float(getattr(cell, k)) - v) <= 1e-5 * abs(v), (c, k)
