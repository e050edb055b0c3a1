"""The ``batched_feasible`` router's scoring through
``repro_torch.kernels.ops.fleet_feasibility``, on the CPU (where the call
runs the kernel's plain version) against the reference's
``jax_queue.feasible_nodes``.

The router packs each decision's ledgers and scalars into one buffer
(``router.FeasibilityStaging``); on CUDA that is one pinned copy, one
``fleet_feasibility`` launch and one read.  These tests hold the verdicts
on every decision the event heap makes under ``batched_feasible`` on the
three paper scenarios with campus pricing, the one-call-a-decision
contract, and the packed views against the three-array build the router
used before.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_queue as jq
from repro_torch.core import torch_queue as tq
from repro_torch.fleetsim import validate
from repro_torch.kernels import ops
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import Topology, UniformWorkload, get_workload
from repro_torch.orchestration import router as rmod

BIG = 1e30
HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
# decisions of one (K, cap) held against the reference in one vmapped call
BATCH = 512

_reference = jax.jit(jax.vmap(jq.feasible_nodes))


class _Recorder:
    """Wraps ``ops.fleet_feasibility``: keeps each call's inputs and
    verdicts, grouped by (K, cap), and holds a full group against the
    reference's verdicts in one vmapped call."""

    def __init__(self, real):
        self.real, self.calls = real, 0
        self.groups = collections.defaultdict(list)
        self.caps = collections.Counter()

    def __call__(self, *args):
        out = self.real(*args)
        starts, ends, sizes, n, ps, d, cpu_free, head = args
        assert not head.any()
        key = tuple(starts.shape)
        self.calls += 1
        self.caps[key[1]] += 1
        self.groups[key].append(tuple(t.numpy().copy() for t in (
            starts, ends, sizes, n, ps, d, cpu_free, out[0])))
        if len(self.groups[key]) == BATCH:
            self.flush(key)
        return out

    def flush(self, key):
        rows = self.groups.pop(key)
        pad = rows + [rows[-1]] * (BATCH - len(rows))
        st, en, sz, n, ps, d, free, got = (np.stack(c) for c in zip(*pad))
        want = np.asarray(_reference(
            jq.Ledger(jnp.asarray(st), jnp.asarray(en), jnp.asarray(sz),
                      jnp.asarray(n)),
            jnp.asarray(ps), jnp.asarray(d[:, 0]), jnp.asarray(free)))
        bad = np.flatnonzero((got != want).any(1)[:len(rows)])
        assert bad.size == 0, (
            f"{bad.size} decisions at (K, cap) {key} differ from "
            f"jax_queue.feasible_nodes, first {rows[bad[0]]}")

    def flush_all(self):
        for key in list(self.groups):
            self.flush(key)


def test_verdicts_equal_the_reference_on_every_heap_decision(monkeypatch):
    """(a) Every ``batched_feasible`` decision of the event heap on
    ``paper/scenario1..3`` under campus pricing (16,056 decisions; caps 64
    to 1024): ``ops.fleet_feasibility`` on the CPU gives
    ``jax_queue.feasible_nodes``'s verdict on the same ledgers."""
    rec = _Recorder(ops.fleet_feasibility)
    monkeypatch.setattr(ops, "fleet_feasibility", rec)
    forwards = 0
    for sc in ("paper/scenario1", "paper/scenario2", "paper/scenario3"):
        w = get_workload(sc)
        topo = Topology.full_mesh(w.n_nodes)
        out = validate._host_run(w, topo, 0, "batched_feasible", 2, False,
                                 network=LinkModel.campus(topo), device="cpu")
        forwards += out[1].forwards
    rec.flush_all()
    assert rec.calls == forwards == 16056
    assert set(rec.caps) == {64, 128, 256, 512, 1024}


def test_one_kernel_call_a_decision_and_no_feasible_nodes(monkeypatch):
    """(b) ``Router("batched_feasible", device="cpu")`` scores each decision
    with one ``ops.fleet_feasibility`` call and never calls
    ``torch_queue.feasible_nodes``."""
    calls = collections.Counter()

    def count(name, real):
        def spy(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return spy

    real_decide = rmod.Router._batched_feasible

    def decide(self, nodes, src, cand_ids, request, now):
        calls["decisions"] += request is not None
        return real_decide(self, nodes, src, cand_ids, request, now)

    monkeypatch.setattr(ops, "fleet_feasibility",
                        count("kernel", ops.fleet_feasibility))
    monkeypatch.setattr(tq, "feasible_nodes",
                        count("feasible_nodes", tq.feasible_nodes))
    monkeypatch.setattr(rmod.Router, "_batched_feasible", decide)
    w = UniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
    topo = Topology.full_mesh(3)
    out = validate._host_run(w, topo, 0, "batched_feasible", 2, False,
                             network=LinkModel.campus(topo), device="cpu")
    assert calls["decisions"] > 50 and out[1].forwards > 0
    assert calls["kernel"] == calls["decisions"]
    assert calls["feasible_nodes"] == 0


def _three_arrays(blocks):
    """The router's ledger build before it packed one buffer: three
    (K, cap) f32 arrays filled element by element, and (K,) ``n``."""
    cap = max(8, max((len(b) for b in blocks), default=0) + 1)
    cap = 1 << (cap - 1).bit_length()
    K = len(blocks)
    starts = np.full((K, cap), BIG, np.float32)
    ends = np.full((K, cap), BIG, np.float32)
    sizes = np.zeros((K, cap), np.float32)
    for k, blist in enumerate(blocks):
        for j, (s, e) in enumerate(blist):
            starts[k, j] = s
            ends[k, j] = e
            sizes[k, j] = e - s
    return starts, ends, sizes, np.asarray([len(b) for b in blocks],
                                           np.int32)


def _blocks(rng, K, longest):
    """K rows of back-to-back and gapped (start, end) blocks in float64
    with non-dyadic times; row lengths up to ``longest``, one row empty
    where K > 1."""
    out = []
    for k in range(K):
        m = 0 if (k == 1 and K > 1) else int(rng.integers(0, longest + 1))
        if k == 0:
            m = longest
        t = float(rng.uniform(0, 5e4))
        row = []
        for _ in range(m):
            s = t + (0.0 if rng.random() < 0.5 else float(rng.uniform(0, 30)))
            e = s + float(rng.choice([4.0, 9.7, 12.1, 180.0 / 3]))
            row.append((s, e))
            t = e
        out.append(row)
    return out


def test_packed_views_hold_the_three_array_build():
    """(c) The packed views equal the three-array build (ledgers, ``n``)
    and the scalars ``torch.tensor`` made, with ``head`` 0, for K = 1, 2,
    5 and a cap that grows from 8 to 1024 between decisions and shrinks
    again, on one staging buffer."""
    rng = np.random.default_rng(7)
    staging = rmod.FeasibilityStaging(torch.device("cpu"))
    sizes_seen = []
    for K, longest in ((1, 3), (2, 7), (5, 100), (2, 700), (1, 0), (5, 20)):
        blocks = _blocks(rng, K, longest)
        ps = [float(x) for x in rng.uniform(1, 200, K)]
        frees = [float(x) for x in rng.uniform(0, 6e4, K)]
        d = float(rng.uniform(0, 1e5))
        Kp, cap = staging.pack(blocks, ps, frees, d)
        starts, ends, sizes, n = _three_arrays(blocks)
        assert (Kp, cap) == (K, starts.shape[1])
        got = staging.to_device(K, cap)
        for g in got:
            assert g.is_contiguous() and g.device.type == "cpu"
        g_st, g_en, g_sz, g_n, g_ps, g_d, g_free, g_head = got
        np.testing.assert_array_equal(g_st.numpy(), starts)
        np.testing.assert_array_equal(g_en.numpy(), ends)
        np.testing.assert_array_equal(g_sz.numpy(), sizes)
        assert g_n.dtype == g_head.dtype == torch.int32
        assert g_n.tolist() == n.tolist() and not g_head.any()
        f32 = torch.float32
        assert torch.equal(g_ps, torch.tensor(ps, dtype=f32))
        assert torch.equal(g_free, torch.tensor(frees, dtype=f32))
        assert torch.equal(g_d, torch.tensor([d], dtype=f32))
        want = tq.feasible_nodes(
            tq.Ledger(*(torch.from_numpy(a) for a in (starts, ends, sizes,
                                                      n))),
            torch.tensor(ps, dtype=f32), torch.tensor(d, dtype=f32),
            torch.tensor(frees, dtype=f32))
        assert torch.equal(ops.fleet_feasibility(*got)[0], want)
        sizes_seen.append(staging.host.numel())
    assert sizes_seen == sorted(sizes_seen) and sizes_seen[-1] > sizes_seen[0]


@pytest.mark.parametrize("K", [1, 2, 5])
def test_staged_views_layout(K):
    """The views tile the buffer's ``3 K cap + 4 K + 1`` words in order,
    without overlap."""
    cap = 16
    words = 3 * K * cap + 4 * K + 1
    buf = torch.arange(words, dtype=torch.float32)
    seen = []
    for v in rmod.staged_views(buf, K, cap):
        seen.append(v.view(torch.float32).reshape(-1) if v.dtype ==
                    torch.int32 else v.reshape(-1))
    order = torch.cat([seen[i] for i in (0, 1, 2, 3, 7, 4, 6, 5)])
    assert torch.equal(order, buf)


@pytest.mark.parametrize("K,N", [(1, 1), (3, 7), (2, 64), (5, 1000),
                                 (2, 4099)])
def test_lane_tree_sum_follows_the_kernels_association(K, N):
    """``ref.lane_tree_sum`` (what the CUDA fleet kernels' ``load`` must
    equal bit for bit) sums as fleet_row.cuh does: lane l over slots l,
    l + 32, ... in order, then the xor butterfly; on non-dyadic values it
    differs from PyTorch's order by less than ``ref.sum_order_rtol``."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(K * N)
    x = (rng.uniform(0, 200, (K, N)) / 3).astype(np.float32)
    want = []
    for row in x:
        lanes = np.zeros(32, np.float32)
        for i, v in enumerate(row):
            lanes[i % 32] = np.float32(lanes[i % 32] + v)
        for o in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
        want.append(lanes[0])
    got = ref.lane_tree_sum(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(want, np.float32))
    assert torch.allclose(got, torch.from_numpy(x).sum(1),
                          rtol=ref.sum_order_rtol(N), atol=0.0)
