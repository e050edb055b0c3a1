"""The plain references against the program they judge, on the CPU at a
small size: the ViT forward in float32, the position resize, and the
engine's decisions."""
import pytest
import torch
import torch.nn.functional as F

from perfbench import inputs, spec, traffic
from perfbench.drivers.vision_serving import program_config
from perfbench.reference import engine as ref_engine
from perfbench.reference import vit as ref_vit
from perfbench.tests import smoke


@pytest.mark.parametrize("n_from,n_to", [(4, 6), (14, 24), (16, 27), (6, 4)])
def test_resize_matches_antialiased_bilinear(n_from, n_to):
    g = torch.randn(1, 3, n_from, n_from, dtype=torch.float64)
    want = F.interpolate(g, size=(n_to, n_to), mode="bilinear",
                         align_corners=False, antialias=True)
    r = ref_vit.resize_matrix(n_from, n_to)
    got = torch.einsum("ai,cij,bj->cab", r, g[0], r)
    assert torch.allclose(got, want[0], atol=1e-12)


@pytest.mark.parametrize("res", [32, 48])
@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
def test_vit_reference_matches_program_in_f32(res, seed):
    from repro_torch.models import vit
    cfg = smoke.config()
    cfg["dtype"] = "float32"
    m = cfg["model"]
    dev = torch.device("cpu")
    leaves = inputs.draw_weights(inputs.vit_layout(m), seed, torch.float32,
                                    dev)
    x = inputs.draw_frames(5, res, inputs.frames_generator(seed, dev), dev)
    prog = vit.forward(inputs.tree(leaves), x, program_config(cfg))
    ref = ref_vit.logits(leaves, x, m, block=2)
    assert torch.allclose(prog, ref, atol=2e-5, rtol=1e-5)


def test_fp8_rounds_to_e4m3():
    t = torch.linspace(-3, 3, 101)
    q = ref_vit.fp8(t)
    assert (q - t).abs().max() <= 3 * 2 ** -4
    assert not torch.equal(q, t)


@pytest.mark.parametrize("name", ["surveillance_peak", "hd_trickle"])
def test_engine_reference_matches_program(name):
    from repro_torch.serving.engine import (DeadlineAwareEngine, ServiceClass,
                                            ServingReplica)
    mix = spec.traffic(name)
    classes, rcl = [], []
    for c in mix["classes"]:
        sc = ServiceClass(c["name"], c["resolution"], deadline=c["deadline"],
                          proc_time=c["proc_time"])
        sc.batch_proc_time = traffic.batch_times(c, mix["batch_model"])
        classes.append(sc)
        rcl.append(dict(name=c["name"], deadline=c["deadline"],
                        proc_time=c["proc_time"],
                        batch_times=sc.batch_proc_time))
    for k in range(3):
        ep = traffic.episode(mix, 2 ** 31 + 99, k)
        batches = []

        def replica(rid):
            def run(cls_name, payloads):
                batches.append((rid, cls_name, tuple(i for i, _ in payloads)))
                return [0] * len(payloads)
            return run
        reps = [ServingReplica(i, replica(i), max_batch=mix["max_batch"])
                for i in range(mix["replicas"])]
        eng = DeadlineAwareEngine(reps, max_forwards=mix["max_forwards"],
                                  rng_seed=ep["rng_seed"],
                                  forward_policy=mix["policy"], device="cpu")
        reqs = [eng.submit((i, None), classes[c], now=t, origin=o)
                for i, (t, c, o) in enumerate(zip(ep["arrivals"], ep["cls"],
                                                  ep["origin"]))]
        eng.drain(ep["arrivals"][-1])
        want = ref_engine.serve(rcl, ep["arrivals"], ep["cls"], ep["origin"],
                                mix["replicas"], mix["max_batch"],
                                mix["max_forwards"], ep["rng_seed"])
        served = {i: rid for rid, _, ids in batches for i in ids}
        assert [served[i] for i in range(len(reqs))] == want["replica"]
        assert [r.forwards for r in reqs] == want["forwards"]
        assert [r.done_at for r in reqs] == want["done_at"]
        assert batches == want["batches"]
        assert eng.stats() == want["stats"]
