"""The port's radio access model (``repro_torch.netsim.radio``) against the
JAX package's (``repro.netsim.radio``), on the CPU: the random-mobility
traces draw for draw, ``RadioWorkload``'s requests field for field
(budgets clamped to ``MIN_DEADLINE`` included), the zero radio as the
identity, and the port's ``run_validation`` on the radio workloads of
tests/test_netsim.py (the hot fleet with mobility, a handover on an
arrival tick, the dead-on-arrival uplink) reproducing the reference's
report."""
import dataclasses
import math

import numpy as np
import pytest

import repro.netsim as jn
import repro.netsim.radio as jr
import repro.orchestration as jo
import repro_torch.netsim as tn
import repro_torch.netsim.radio as tr
import repro_torch.orchestration as to
from repro.core.request import Request as JRequest, Service as JService
from repro.fleetsim.validate import run_validation as j_run_validation
from repro_torch.core.request import Request as TRequest, Service as TService
from repro_torch.fleetsim import validate

HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
# the fleet's f32 sums over requests, taken in another order by XLA
FLEET_SUMS = ("mean_response_time", "transfer_time")


def key(requests):
    return [(r.service.name, r.service.proc_time, r.service.deadline,
             r.arrival_time, r.origin_node) for r in requests]


class Pkg:
    """One package's names, so each case is built the same way in both."""

    def __init__(self, net, radio, orch):
        self.net, self.radio, self.orch = net, radio, orch

    def campus(self, n=3):
        return self.net.LinkModel.campus(self.orch.Topology.full_mesh(n))


J, T = Pkg(jn, jr, jo), Pkg(tn, tr, to)


def mobile(p, n_ues, horizon, rate, seed, cells_per_node=1, n=3):
    return p.net.RadioModel.from_link(p.campus(n), cells_per_node) \
        .with_random_mobility(n_ues, horizon=horizon,
                              handovers_per_ue=rate, seed=seed)


@pytest.mark.parametrize("n_ues,horizon,rate,seed,cells", [
    (3, 110_000.0, 3.0, 0, 1),            # examples/mobility_sweep.py
    (20, 1000.0, 2.0, 3, 1),
    (50, 500.0, 0.5, 1, 2),
    (7, 2000.0, 12.0, 5, 3),
])
def test_random_mobility_equals_reference(n_ues, horizon, rate, seed, cells):
    a = mobile(J, n_ues, horizon, rate, seed, cells)
    b = mobile(T, n_ues, horizon, rate, seed, cells)
    assert a.mobility == b.mobility and a.name == b.name
    assert sum(b.handovers(u) for u in range(n_ues)) > 0
    for ue in range(n_ues):
        for t in (0.0, horizon / 3, horizon / 2, horizon, 2 * horizon):
            assert dataclasses.astuple(a.cell_of(ue, t)) == \
                dataclasses.astuple(b.cell_of(ue, t))


def test_mobility_keeps_attachment_and_draws_other_cells():
    for p in (J, T):
        cells = [p.radio.CellSite(i, i % 2) for i in range(4)]
        radio = p.net.RadioModel(cells, attachment={0: 3}) \
            .with_random_mobility(6, horizon=100.0, handovers_per_ue=4.0,
                                  seed=2)
        assert radio.attachment == {0: 3} and radio.n_nodes == 2
        for ue, events in radio.mobility.items():
            prev = radio.initial_cell(ue)
            for t, c in events:
                assert 0.0 <= t <= 100.0 and c != prev
                prev = c
    assert mobile(J, 6, 100.0, 4.0, 2).mobility == \
        mobile(T, 6, 100.0, 4.0, 2).mobility


def workloads(p):
    """Each package's radio workloads: the paper's volume on the static and
    the mobile campus radio (examples/mobility_sweep.py), the hot fleet
    without a link model, and a slow uplink that clamps budgets."""
    link = p.campus()
    s1 = p.orch.get_workload("paper/scenario1")
    hot = p.orch.UniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
    static = p.net.RadioModel.from_link(link)
    slow = [p.radio.CellSite(i, i, uplink_latency=3990.0,
                             uplink_bandwidth=0.05) for i in range(3)]
    return {
        "static": p.radio.RadioWorkload(s1, static, link=link),
        "mobile": p.radio.RadioWorkload(s1, mobile(p, 3, 110_000.0, 3.0, 0),
                                        link=link),
        "hot_no_link": p.radio.RadioWorkload(hot, mobile(p, 3, 1200.0, 1.0,
                                                         0)),
        "clamped": p.radio.RadioWorkload(
            hot, p.net.RadioModel(slow).with_random_mobility(
                3, horizon=1200.0, handovers_per_ue=2.0, seed=1)),
    }


@pytest.mark.parametrize("name", ["static", "mobile", "hot_no_link",
                                  "clamped"])
@pytest.mark.parametrize("seed", [0, 2])
def test_radio_workload_equals_reference(name, seed):
    a, b = workloads(J)[name], workloads(T)[name]
    assert (a.name, a.n_nodes) == (b.name, b.n_nodes)
    ra, rb = a.generate(seed), b.generate(seed)
    assert key(ra) == key(rb)
    (xa, na), (xb, nb) = a.to_arrays(seed), b.to_arrays(seed)
    assert na == nb
    for field, x, y in zip(xa._fields, xa, xb):
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    if name == "clamped":
        floor = [r for r in rb if r.service.deadline == tr.MIN_DEADLINE]
        assert floor and all(r.service.deadline >= tr.MIN_DEADLINE
                             for r in rb)
        assert len(floor) < len(rb)       # S1's budget survives the uplink
    if name == "mobile":
        assert {r.origin_node for r in rb} == {0, 1, 2}


def test_budgeted_services_keep_names_and_share_objects():
    """The packed arrays key services by name (both packages): a budgeted
    service keeps its name and carries its own deadline, one object per
    (name, proc_time, budget)."""
    wl = workloads(T)["static"]
    reqs = wl.generate(0)
    by_name = {}
    for r in reqs:
        by_name.setdefault(r.service.name, set()).add(id(r.service))
    assert all(len(ids) == 1 for ids in by_name.values())
    arrays, names = wl.to_arrays(0)
    assert names == tuple(sorted(by_name))
    base = {r.service.name: r.service.deadline
            for r in to.get_workload("paper/scenario1").generate(0)}
    up = T.campus().uplink_delay
    for r, dl in zip(reqs, arrays.rel_deadline):
        assert r.service.deadline == base[r.service.name] - up(r.service)
        assert dl == np.float32(r.service.deadline)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_zero_radio_is_the_identity(pkg):
    p = J if pkg == "reference" else T
    base = p.orch.UniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
    wl = p.radio.RadioWorkload(
        base, p.net.RadioModel.per_node(p.orch.Topology.full_mesh(3)))
    a, b = base.generate(0), wl.generate(0)
    assert key(a) == key(b)
    assert all(x.service is y.service for x, y in zip(a, b))
    if p is T:
        assert key(b) == key(workloads(J)["hot_no_link"].base.generate(0))


def test_handover_takes_effect_on_its_tick():
    for p in (J, T):
        cells = [p.radio.CellSite(i, node=i) for i in range(3)]
        radio = p.net.RadioModel(cells, attachment={0: 0},
                                 mobility={0: [(50.0, 1)]})
        assert radio.ingress(0, 49.9) == 0 and radio.ingress(0, 50.0) == 1
        assert radio.ingress(0, np.nextafter(50.0, 0.0)) == 0
        assert radio.handovers(0) == 1 and radio.handovers(1) == 0


def test_invalid_models_raise():
    with pytest.raises(ValueError):
        tn.RadioModel([])
    with pytest.raises(ValueError):
        tn.RadioModel([tn.CellSite(0, 0), tn.CellSite(0, 1)])
    with pytest.raises(ValueError):
        tn.RadioModel([tn.CellSite(0, 0)], mobility={0: [(1.0, 5)]})
    assert tn.CellSite(0, 0, 2.0, math.inf).uplink_delay(9.0) == 2.0
    assert tn.CellSite(0, 0, 2.0, 0.5).uplink_delay(1.0) == 4.0


# ---------------------------------------------------------------------------
# run_validation on the radio workloads of tests/test_netsim.py:655-724
# ---------------------------------------------------------------------------
def _ticked(p, Req, Svc):
    """tests/test_netsim.py's handover on an arrival tick."""
    cells = [p.radio.CellSite(0, node=0), p.radio.CellSite(1, node=1),
             p.radio.CellSite(2, node=2)]
    radio = p.net.RadioModel(cells, attachment={0: 0},
                             mobility={0: [(50.0, 1)]})
    svc = Svc("s", 1, "x", proc_time=10.0, deadline=400.0)

    class _Ticked(p.orch.Workload):
        name = "tick"
        n_nodes = 3

        def generate(self, seed):
            return self._finish([Req(service=svc, arrival_time=t,
                                     origin_node=0)
                                 for t in (49.5, 50.0, 50.5)])

    return p.radio.RadioWorkload(_Ticked(), radio)


def _doa(p):
    """tests/test_netsim.py's uplink that eats the whole SLA budget."""
    cells = [p.radio.CellSite(0, node=0, uplink_latency=5000.0),
             p.radio.CellSite(1, node=1, uplink_latency=5000.0)]
    base = p.orch.UniformWorkload([{"S6": 4}, {"S6": 4}], window=200.0,
                                  name="doa")
    return p.radio.RadioWorkload(base, p.net.RadioModel(cells))


def _hot_mobile(p):
    """tests/test_netsim.py's mobility + uplink pricing run."""
    link = p.campus()
    hot = p.orch.UniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
    radio = p.net.RadioModel.from_link(link).with_random_mobility(
        3, horizon=1200.0, handovers_per_ue=1.0, seed=0)
    return p.radio.RadioWorkload(hot, radio, link=link), link


def _same_report(a, b):
    for f in dataclasses.fields(b):
        if f.name != "fleet":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    for k, v in a.fleet.items():
        if k in FLEET_SUMS:
            assert abs(b.fleet[k] - v) <= 1e-5 * abs(v), k
        else:
            assert b.fleet[k] == v, k
    assert b.exact, b.row()


@pytest.mark.parametrize("policy", ["random", "batched_feasible",
                                    "round_robin"])
def test_hot_mobile_validation_matches_reference(policy):
    jw, jl = _hot_mobile(J)
    tw, tl = _hot_mobile(T)
    a = j_run_validation(jw, 0, policy=policy, network=jl)
    b = validate.run_validation(tw, 0, policy=policy, network=tl,
                                device="cpu")
    _same_report(a, b)
    assert b.host["forwards"] > 0 and b.host["transfer_time"] > 0


def test_handover_tick_validation_matches_reference():
    wls = _ticked(J, JRequest, JService), _ticked(T, TRequest, TService)
    assert [r.origin_node for r in wls[1].generate(0)] == [0, 1, 1]
    a = j_run_validation(wls[0], 0, policy="round_robin",
                         topology=jo.Topology.full_mesh(3))
    b = validate.run_validation(wls[1], 0, policy="round_robin",
                                topology=to.Topology.full_mesh(3),
                                device="cpu")
    _same_report(a, b)


@pytest.mark.parametrize("policy", ["round_robin", "random"])
def test_dead_on_arrival_validation_matches_reference(policy):
    """Budgets clamped to ``MIN_DEADLINE``: every request admitted
    nowhere, forced, late, on both engines of both packages."""
    jw, tw = _doa(J), _doa(T)
    reqs = tw.generate(0)
    assert key(reqs) == key(jw.generate(0))
    assert all(0 < r.service.deadline <= tr.MIN_DEADLINE for r in reqs)
    a = j_run_validation(jw, 0, policy=policy,
                         topology=jo.Topology.full_mesh(2))
    b = validate.run_validation(tw, 0, policy=policy,
                                topology=to.Topology.full_mesh(2),
                                device="cpu")
    _same_report(a, b)
    assert b.fleet["met_deadline"] == 0
    assert b.fleet["processed"] == len(reqs)
