"""The port's dry run and cost model (``repro_torch.launch.{dryrun,
op_cost,roofline}``, ``kernels.library``) against the JAX reference's
(``repro.launch.{dryrun,hlo_cost,roofline}``), on the CPU.

The full-size (cell, mesh) pairs are held to ``tests/data/
torch_dryrun_golden.json`` (``tests/make_torch_dryrun_golden.py``): the
rules, the argument bytes and the model FLOPs of all 74.  Per-chip FLOPs
are held to the reference's ``hlo_cost`` at smoke size (the golden's
``smoke`` section, with each product's per-chip FLOPs): within 2% on one
device and on a 2x4 mesh, where a product whose layout differs from
XLA's is named below with both layouts and the rest compared.
"""
import json
import math
import os
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.launch import roofline as jroof
from repro_torch.configs import all_cells, get_config, get_smoke_config
from repro_torch.configs.shapes import ShapeSpec, shapes_for
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import library
from repro_torch.kernels import moe_gemm as mg_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn_mod
from repro_torch.launch import dryrun, op_cost, roofline, steps
from repro_torch.launch import mesh as lmesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from make_torch_dryrun_golden import SMOKE_CELLS  # noqa: E402

GOLDEN = json.load(open(os.path.join(HERE, "data",
                                     "torch_dryrun_golden.json")))
CELLS, SKIPS = all_cells()
REL = 0.02


def _reference_parse_override():
    """The reference's ``_parse_override``, its module imported with the
    environment kept (the module sets ``XLA_FLAGS`` at import)."""
    env = dict(os.environ)
    try:
        from repro.launch import dryrun as jdry
    finally:
        os.environ.clear()
        os.environ.update(env)
    return jdry._parse_override


# ---------------------------------------------------------------------------
# the CLI's pieces and the roofline arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("val", ["true", "True", "false", "False", "none",
                                 "None", "0", "-3", "12", "1.5", "1e-3",
                                 "nan", "inf", "chunked", "data,model", ""])
def test_parse_override_matches_reference(val):
    got, want = dryrun._parse_override(val), \
        _reference_parse_override()(val)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference_and_golden(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    s = shapes_for(cfg)[shape]
    got = roofline.model_flops_estimate(cfg, s)
    assert got == jroof.model_flops_estimate(jcfg, s)
    for mesh in ("single", "multi"):
        assert got == GOLDEN["pairs"][f"{arch}:{shape}:{mesh}"][
            "model_flops"]


def test_roofline_terms_under_both_constants():
    """The same fields, properties and summary keys as the reference's;
    each term the count over the card's peak (the reference's over a TPU
    v5e's)."""
    kw = dict(flops=3.2e15, hbm_bytes=4.4e12, coll_bytes=2.5e11,
              coll_breakdown={"all-gather": 2e11, "all-reduce": 5e10},
              model_flops=6.0e17, chips=256)
    got, want = roofline.RooflineTerms(**kw), jroof.RooflineTerms(**kw)
    assert got.t_compute == kw["flops"] / 989e12
    assert got.t_memory == kw["hbm_bytes"] / 3.35e12
    assert got.t_collective == kw["coll_bytes"] / 50e9
    assert want.t_compute == kw["flops"] / jroof.PEAK_FLOPS
    assert want.t_memory == kw["hbm_bytes"] / jroof.HBM_BW
    assert got.t_compute * roofline.PEAK_FLOPS == \
        want.t_compute * jroof.PEAK_FLOPS
    assert got.useful_ratio == want.useful_ratio == \
        kw["model_flops"] / (kw["flops"] * 256)
    assert got.summary().keys() == want.summary().keys()
    assert got.bottleneck == "collective" and want.bottleneck == "compute"
    t = max(got.t_compute, got.t_memory, got.t_collective)
    assert got.roofline_fraction == got.t_compute / t
    assert roofline.NVLINK_BW == 450e9
    none = roofline.RooflineTerms(0, 0, 0, {}, 0, 1)
    assert none.useful_ratio == 0 and none.roofline_fraction == 0


# ---------------------------------------------------------------------------
# the cost model on a hand-counted program
# ---------------------------------------------------------------------------
def test_two_products_on_a_2x4_mesh_counted_by_hand():
    """x (8, 16) rows over data, w1 (16, 32) columns over model, w2 (32,
    16) rows over model, f32: y = x w1 splits 8 ways with no collective;
    z = y w2 contracts over model on both sides, so each chip sums a
    partial (8 / 2, 16) block and one all-reduce adds them."""
    mode = op_cost.CostMode({"data": 2, "model": 4})
    with FakeTensorMode() as fm:
        x, w1, w2 = (torch.empty(s) for s in ((8, 16), (16, 32), (32, 16)))
    mode.set_spec(x, (("data",), ()))
    mode.set_spec(w1, ((), ("model",)))
    mode.set_spec(w2, (("model",), ()))
    with fm, mode:
        z = (x @ w1) @ w2
    c = mode.costs
    assert c.flops == 2 * 8 * 16 * 32 / 8 + 2 * 8 * 32 * 16 / 8 == 2048
    # y = x w1: x 4x16, w1 16x8, y 4x8 a chip; z: y, w2 8x16, z 4x16; f32
    assert c.bytes == 4 * (4 * 16 + 16 * 8 + 4 * 8) + \
        4 * (4 * 8 + 8 * 16 + 4 * 16) == 1792
    assert c.coll_by_kind == {"all-reduce": 4 * 4 * 16} and \
        c.coll_bytes == 256
    assert mode.spec(z) == (("data",), ())
    assert mode.products == [("mm", ((8, 16), (16, 32)), (4, 8), 1024.0),
                             ("mm", ((8, 32), (32, 16)), (4, 16), 1024.0)]


def test_views_are_free_and_an_in_place_write_counts_once():
    mode = op_cost.CostMode()
    with FakeTensorMode() as fm:
        a = torch.empty(64, 32)
        b = torch.empty(64, 32)
    with fm, mode:
        v = a.view(32, 64)[:16].unsqueeze(0).squeeze(0).t()
        assert mode.costs.bytes == 0 and v.shape == (64, 16)
        a.add_(b)                       # reads a and b, writes a
    assert mode.costs.bytes == 2 * 64 * 32 * 4 and mode.costs.flops == 0


def test_reshape_splits_an_axis_over_two_dims():
    """A 4-way axis on H = 4 heads reshaped to (KV 2, G 2): its major half
    on KV, its minor half on G; merged back, the axis whole."""
    mode = op_cost.CostMode({"data": 2, "model": 4})
    spec = mode._reshape((8, 4, 16), ((), ("model",), ()), (8, 2, 2, 16))
    assert spec == ((), ("model|2<",), ("model|2>",), ())
    assert mode._reshape((8, 2, 2, 16), spec, (8, 4, 16)) == \
        ((), ("model",), ())
    assert mode.shards(spec) == 4


# ---------------------------------------------------------------------------
# the 74 pairs: rules and argument bytes against the golden
# ---------------------------------------------------------------------------
@pytest.fixture
def production_group():
    with dryrun.fake_group():
        yield {m: lmesh.make_production_mesh(m == "multi", "cpu")
               for m in ("single", "multi")}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_rules_and_argument_bytes_match_golden(production_group, arch,
                                               shape):
    """Every pair, the nine that ``placements`` refused before its
    ``_StridedShard`` placements included: rank 0's shard bytes equal
    XLA's ``argument_size_in_bytes`` byte for byte."""
    cell = steps.build_cell(arch, shape)
    for name, m in production_group.items():
        want = GOLDEN["pairs"][f"{arch}:{shape}:{name}"]
        rules = lmesh.install_rules(m, cell.cfg, cell.shape.global_batch,
                                    kind=cell.shape.kind)
        try:
            got = {k: list(v) if isinstance(v, tuple) else v
                   for k, v in rules.items()}
            assert got == want["rules"], name
            sh = dryrun._to_shardings(m, cell.arg_logical, cell.arg_specs)
            n = sum(dryrun._leaves(dryrun._map2(
                lambda s, x: dryrun.shard_bytes(m, s, x), cell.arg_specs,
                sh)))
            assert n == want["memory"]["argument_bytes"], name
        finally:
            shd.clear_rules()


def test_skips_are_the_references():
    assert [{"arch": a, "shape": s, "reason": r} for a, s, r in SKIPS] == \
        GOLDEN["skips"]


# ---------------------------------------------------------------------------
# per-chip FLOPs at smoke size against hlo_cost
# ---------------------------------------------------------------------------
def smoke_cell(name, arch, kind, seq, batch, res):
    shape = ShapeSpec(f"smoke_{name}", kind, seq_len=seq, global_batch=batch,
                      img_res=res)
    return steps.build_cell(arch, shape.name, cfg=get_smoke_config(arch),
                            shape=shape)


# Products whose per-chip work differs from XLA's because the layouts
# differ, by (cell, "one" / "mesh"): a description, the port's products
# (``CostMode.products``: name, whole operand shapes, block, FLOPs) and
# the reference's (``[flops, result type]`` of the golden's ``dots``).
NAMED = {
    ("lm_train", "one"): (
        "the loss chunk's logits, h (384, 64) x head (64, 128): the port's "
        "checkpointed chunk recomputes them in the backward (6 products of "
        "that shape with the MLP's gate), XLA's one-trip scan computes them "
        "once (5)",
        lambda n, ins, loc, f: ins == ((384, 64), (64, 128)),
        lambda f, t: t == "f32[384,128]"),
    ("lm_train", "mesh"): (
        "the attention projections and their gradients (q / o 64 wide, k / v "
        "32): here k and v split 8 ways (48 or 8 rows a chip) and q and o 4 "
        "(192 rows, 16 columns), 12 and 12 products; XLA splits k and v 4 "
        "ways too (f32[192,16], f32[192,64], f32[16,32] ... a chip), 24 "
        "products at 196,608 / 393,216 FLOPs a chip",
        lambda n, ins, loc, f: f in (196608.0, 393216.0),
        lambda f, t: f in (196608.0, 393216.0)),
    ("lm_decode", "mesh"): (
        "the K / V projections (8, 64) x (64, 32): here 8 ways (one row a "
        "chip, rows over data and model), XLA's over data only (f32[4,32] a "
        "chip)",
        lambda n, ins, loc, f: ins == ((8, 64), (64, 32)),
        lambda f, t: t == "f32[4,32]"),
    ("moe_prefill", "mesh"): (
        "the router logits (384, 48) x (48, 5): here 8 ways (48 rows a chip), "
        "XLA's over data only (f32[192,5] a chip)",
        lambda n, ins, loc, f: ins == ((384, 48), (48, 5)),
        lambda f, t: t == "f32[192,5]"),
    ("dit_serve", "mesh"): (
        "the patch embedding, a (128, 16) x (16, 64) product here split 8 "
        "ways, XLA's convolution over data only (f32[4,4,4,64] a chip); and "
        "jax.image.resize's bilinear products of the position table "
        "(f32[256,4], f32[4,128]), an interpolation without products here",
        lambda n, ins, loc, f: ins == ((128, 16), (16, 64)),
        lambda f, t: t in ("f32[4,4,4,64]", "f32[256,4]", "f32[4,128]")),
}


@pytest.fixture(scope="module")
def smoke_counts():
    out = {}
    with dryrun.fake_group(8):
        m = lmesh.mesh_over((2, 4), ("data", "model"), "cpu")
        for row in SMOKE_CELLS:
            cell = smoke_cell(*row)
            _, one, _ = dryrun.count_step(cell, "cpu")
            lmesh.install_rules(m, cell.cfg, cell.shape.global_batch,
                                kind=cell.shape.kind)
            try:
                sh = dryrun._to_shardings(m, cell.arg_logical,
                                          cell.arg_specs)
                _, meshed, _ = dryrun.count_step(cell, "cpu", m, sh)
            finally:
                shd.clear_rules()
            out[row[0]] = {"one": one, "mesh": meshed}
    return out


@pytest.mark.parametrize("where", ["one", "mesh"])
@pytest.mark.parametrize("name", [r[0] for r in SMOKE_CELLS])
def test_flops_per_chip_match_hlo_cost(smoke_counts, name, where):
    mode = smoke_counts[name][where]
    ref = GOLDEN["smoke"][name][where]
    got, want = mode.costs.flops, ref["flops"]
    assert sum(p[3] for p in mode.products) == got
    assert sum(f * n for f, t, n in ref["dots"]) == want
    named = NAMED.get((name, where))
    if named is not None:
        _, mine, theirs = named
        got_named = sum(p[3] for p in mode.products if mine(*p))
        want_named = sum(f * n for f, t, n in ref["dots"] if theirs(f, t))
        assert got_named and want_named and got_named != want_named
        got, want = got - got_named, want - want_named
    assert abs(got / want - 1) <= REL, (name, where, got, want)


# ---------------------------------------------------------------------------
# run_cell and main
# ---------------------------------------------------------------------------
def test_run_cell_keys_and_golden_pair():
    res = dryrun.run_cell("deit-b", "serve_b1", False, device="cpu")
    want = GOLDEN["pairs"]["deit-b:serve_b1:single"]
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["rules"] == want["rules"]
    assert res["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] == 1866416
    assert res["memory"]["code_bytes"] is None
    assert res["memory"]["temp_bytes"] > 0 and \
        res["memory"]["output_bytes"] == 4 * 1000
    assert res["model_flops"] == want["model_flops"]
    assert set(res["roofline"]) == {
        "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
        "useful_flops_ratio", "roofline_fraction"}
    assert "xla_cost_analysis" not in res
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape,layers", [
    ("starcoder2-7b", "decode_32k", 2), ("gemma3-27b", "long_500k", 6),
    ("kimi-k2-1t-a32b", "train_4k", 2)])
def test_formerly_refused_pairs_run(arch, shape, layers):
    """Dense-LM decode's ``tp = ("model", "data")`` and Kimi's ``fsdp =
    ("data", "pod")`` on the multi-pod mesh now place (depth cut for the
    test; the CLI runs them at full depth)."""
    for multi in (False, True):
        res = dryrun.run_cell(arch, shape, multi, device="cpu",
                              overrides={"n_layers": layers})
        assert res["status"] == "ok" and res["flops_per_chip"] > 0
        assert res["collective_bytes_per_chip"] > 0


def test_main_writes_results_skips_and_failures(tmp_path, capsys):
    out = tmp_path / "dr"
    dryrun.main(["--arch", "resnet-50", "--shape", "serve_b1", "--mesh",
                 "both", "--device", "cpu", "--out", str(out), "--tag", "t"])
    for m in ("single", "multi"):
        res = json.loads((out / f"resnet-50__serve_b1__{m}__t.json"
                          ).read_text())
        assert res["status"] == "ok"
        assert res["memory"]["argument_bytes"] == GOLDEN["pairs"][
            f"resnet-50:serve_b1:{m}"]["memory"]["argument_bytes"]
    dryrun.main(["--arch", "resnet-50", "--shape", "serve_b1", "--device",
                 "cpu", "--out", str(out), "--tag", "t", "--skip-existing"])
    assert "SKIP (cached)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "resnet-50", "--shape", "serve_b1",
                     "--device", "cpu", "--out", str(out), "--override",
                     "depths=none"])
    res = json.loads((out / "resnet-50__serve_b1__single.json").read_text())
    assert res["status"] == "failed" and "traceback" in res


def test_run_cell_refuses_another_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        with pytest.raises(RuntimeError, match="fake process group of 512"):
            dryrun.run_cell("deit-b", "serve_b1", False, device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 8
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the kernels' operators on fake CUDA tensors: shapes and work, no launch
# ---------------------------------------------------------------------------
def _launches():
    return (fa_mod.flash_attention.launches, rn_mod.rmsnorm.launches,
            rn_mod.rmsnorm_bwd.launches, mg_mod.moe_gemm.launches)


def test_flash_pairs_count_the_key_band():
    """The flash formula's pairs: each 64-row query tile against its
    band's key tiles, cut at S, by brute force over the tiles."""
    for S, causal, window in ((100, True, None), (1100, True, None),
                              (4097, True, 1024), (700, False, None),
                              (640, False, 100)):
        want = 0
        for q_lo in range(0, S, 64):
            rows = min(64, S - q_lo)
            tiles = fa_mod.key_tile_band(q_lo, 64, S, causal, window)
            want += rows * sum(min(64, S - t * 64) for t in tiles)
        assert library.flash_pairs(S, causal, window) == want
    assert library.flash_pairs(256, False, None) == 256 * 256


def test_kernel_operators_on_fake_cuda_tensors():
    from torch.utils.flop_counter import FlopCounterMode
    before = _launches()
    with FakeTensorMode():
        q = torch.empty(2, 1100, 8, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 1100, 2, 64, dtype=torch.bfloat16, device="cuda")
        x = torch.empty(6, 100, 48, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(6, 48, 24, dtype=torch.bfloat16, device="cuda")
        r = torch.empty(300, 48, dtype=torch.bfloat16, device="cuda")
        s = torch.empty(48, dtype=torch.float32, device="cuda")
        with FlopCounterMode(display=False) as fc:
            o = ops.flash_attention(q, k, k, causal=True)
            y = ops.moe_gemm(x, w)
            n = ops.rmsnorm(r, s)
            dx, ds = library.ops.rmsnorm_bwd(r, s, r)
    assert o.shape == q.shape and o.device.type == "cuda"
    assert y.shape == (6, 100, 24) and n.shape == r.shape
    assert dx.shape == r.shape and ds.shape == s.shape and \
        ds.dtype == torch.float32
    assert fc.get_total_flops() == \
        4 * 2 * 8 * 64 * library.flash_pairs(1100, True, None) \
        + 2 * 6 * 100 * 48 * 24
    assert _launches() == before
    with FakeTensorMode(), pytest.raises(ValueError):
        library.ops.moe_gemm(torch.empty(6, 100, 48, device="cuda"),
                             torch.empty(6, 40, 24, device="cuda"))


def test_kernel_operators_sharding_rules():
    """A DTensor that reaches an operator outside ``local_map`` is split
    by its rule: ``moe_gemm`` by experts, ``rmsnorm`` by rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_group(8):
        m = lmesh.mesh_over((8,), ("model",), "cpu")
        x = DTensor.from_local(torch.empty(1, 10, 16, device="meta"), m,
                               [Shard(0)], run_check=False,
                               shape=torch.Size((8, 10, 16)),
                               stride=(160, 16, 1))
        w = DTensor.from_local(torch.empty(1, 16, 4, device="meta"), m,
                               [Shard(0)], run_check=False,
                               shape=torch.Size((8, 16, 4)),
                               stride=(64, 4, 1))
        y = library.ops.moe_gemm(x, w)
        assert y.shape == (8, 10, 4) and y.placements == (Shard(0),)
        r = DTensor.from_local(torch.empty(2, 16, device="meta"), m,
                               [Shard(0)], run_check=False,
                               shape=torch.Size((16, 16)), stride=(16, 1))
        sc = DTensor.from_local(torch.empty(16, device="meta"), m,
                                [Replicate()], run_check=False)
        n = library.ops.rmsnorm(r, sc)
        assert n.placements == (Shard(0),) and n.to_local().shape == (2, 16)
