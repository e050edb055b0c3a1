"""The port's training substrate (``repro_torch.training.{data,
compression, checkpoint, train_loop}``, ``repro_torch.launch.{steps,
train}``) against ``repro.training`` on the CPU, and the reference's own
data, compression and checkpoint tests (``tests/test_training.py``,
``tests/test_checkpoint.py``) mirrored.

Tolerances: batches and checkpoints are compared bit for bit (numpy draws
the same bytes in both packages; checkpoints hold raw values); int8
quantization exactly (the same f32 scale and round-half-even); its
dequantized values and residuals within 1 f32 ulp (2^-23 relative) of
the value's size, where XLA may fuse ``q * scale``.  A resumed run equals
the uninterrupted one bit for bit: the CPU's arithmetic is deterministic
and every batch is a function of its step.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training.data import SyntheticSource as JSource
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import steps as S
from repro_torch.launch import train as train_cli
from repro_torch.models import resnet
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt
from repro_torch.training.data import PrefetchIterator, Spec, SyntheticSource
from repro_torch.training.train_loop import TrainLoopConfig, run

SPECS = {
    "lm": {"tokens": ((4, 33), np.int32), "labels": ((4, 33), np.int32)},
    "vision": {"images": ((3, 16, 16, 3), np.float32),
               "labels": ((3,), np.int32)},
    "diffusion": {"latents": ((2, 4, 4, 4), np.float32),
                  "step": ((), np.int32)},
}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_equal_the_reference_bytes(kind, seed):
    specs = SPECS[kind]
    ours = SyntheticSource({k: Spec(*v) for k, v in specs.items()}, seed)
    theirs = JSource({k: jax.ShapeDtypeStruct(*v) for k, v in specs.items()},
                     seed)
    for step in (0, 1, 13):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (kind, step, k)


def test_deterministic_per_step():
    s = SyntheticSource({"x": Spec((4, 8), np.float32),
                         "y": Spec((4,), np.int32)}, seed=3)
    a, b, c = s.batch_at(7), s.batch_at(7), s.batch_at(8)
    np.testing.assert_array_equal(a["x"], b["x"])
    assert not np.array_equal(a["x"], c["x"])


def test_prefetch_ordering_and_put_fn():
    it = PrefetchIterator(SyntheticSource({"x": Spec((2,), np.float32)}),
                          start_step=5, put_fn=lambda b: {"n": b["x"].size})
    try:
        got = [next(it) for _ in range(4)]
        assert [s for s, _ in got] == [5, 6, 7, 8]
        assert all(b == {"n": 2} for _, b in got)
    finally:
        it.close()


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_int8_quantization_matches_reference(seed):
    x = (np.random.default_rng(seed).standard_normal(257) * (seed + 0.5)
         ).astype(np.float32)
    if seed == 5:
        x[:] = 0.0                       # the 1e-12 floor of the scale
    q, s = comp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    deq = comp.dequantize_int8(q, s).numpy()
    np.testing.assert_allclose(deq, np.asarray(jcomp.dequantize_int8(jq, js)),
                               rtol=0, atol=2.0 ** -23 * np.abs(deq).max())
    assert np.abs(deq - x).max() <= float(s) * 0.5 + 1e-6


def test_feedback_roundtrips_match_reference():
    rng = np.random.default_rng(3)
    resid, jresid = None, None
    for _ in range(5):
        g = {"a": rng.standard_normal(64).astype(np.float32) * 0.01,
             "b": {"c": rng.standard_normal((3, 5)).astype(np.float32)}}
        tg = {"a": torch.from_numpy(g["a"]),
              "b": {"c": torch.from_numpy(g["b"]["c"])}}
        deq, resid = comp.roundtrip_with_feedback(tg, resid)
        jdeq, jresid = jcomp.roundtrip_with_feedback(
            jax.tree_util.tree_map(jnp.asarray, g), jresid)
        for x, y in ((deq["a"], jdeq["a"]), (deq["b"]["c"], jdeq["b"]["c"]),
                     (resid["a"], jresid["a"]),
                     (resid["b"]["c"], jresid["b"]["c"])):
            y = np.asarray(y)
            np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                       atol=2.0 ** -22 * np.abs(y).max())


def test_error_feedback_preserves_mean_signal():
    g = {"w": torch.full((16,), 0.013)}
    resid, total = None, torch.zeros(16)
    for _ in range(50):
        deq, resid = comp.roundtrip_with_feedback(g, resid)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy(), 0.013 * 50, rtol=0.05)


def test_compress_tree_roundtrip():
    g = {"w": torch.linspace(-2, 2, 11), "b": {"c": torch.ones(3)}}
    back = comp.decompress_tree(comp.compress_tree(g), g)
    assert torch.allclose(back["w"], g["w"], atol=2 / 127 / 2 + 1e-7)
    assert back["b"]["c"].dtype == torch.float32


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.randn(16, generator=g).to(torch.bfloat16)},
            "opt": {"m": torch.ones(8, 16),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def leaves_of(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from leaves_of(t[k])
    elif isinstance(t, tuple):
        for v in t:
            yield from leaves_of(v)
    else:
        yield t


def trees_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves_of(a), leaves_of(b)))


def test_roundtrip(tmp_path):
    t = tree()
    ckpt.save_checkpoint(tmp_path, 100, t)
    restored, manifest = ckpt.restore_latest(tmp_path, t)
    assert manifest["step"] == 100
    assert trees_equal(t, restored)
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert manifest["dtypes"]["params/b"] == "bfloat16"
    assert np.load(tmp_path / "step_00000100" / "shard_00000.npz")[
        "params/b"].dtype == np.dtype("V2")


def test_latest_wins(tmp_path):
    ckpt.save_checkpoint(tmp_path, 10, tree(1))
    ckpt.save_checkpoint(tmp_path, 20, tree(2))
    restored, manifest = ckpt.restore_latest(tmp_path, tree(1))
    assert manifest["step"] == 20
    assert trees_equal(tree(2), restored)


def test_keep_last_gc(tmp_path):
    for s in (10, 20, 30, 40, 50):
        ckpt.save_checkpoint(tmp_path, s, tree(), keep_last=2)
    assert sorted(p.name for p in Path(tmp_path).glob("step_*")) == \
        ["step_00000040", "step_00000050"]


def test_shape_mismatch_rejected(tmp_path):
    t = tree()
    ckpt.save_checkpoint(tmp_path, 10, t)
    bad = {"params": {"w": torch.zeros(4, 4), "b": t["params"]["b"]},
           "opt": t["opt"]}
    assert ckpt.restore_latest(tmp_path, bad) is None


def test_halfwritten_checkpoint_ignored(tmp_path):
    t1 = tree(1)
    ckpt.save_checkpoint(tmp_path, 10, t1)
    broken = Path(tmp_path) / "step_00000020"
    broken.mkdir()
    np.savez(broken / "shard_00000.npz", **{"params/w": np.zeros((8, 16))})
    restored, manifest = ckpt.restore_latest(tmp_path, t1)
    assert manifest["step"] == 10 and trees_equal(t1, restored)


def test_corrupt_manifest_ignored(tmp_path):
    ckpt.save_checkpoint(tmp_path, 10, tree(1))
    broken = Path(tmp_path) / "step_00000020"
    broken.mkdir()
    (broken / "manifest.json").write_text("{not json")
    _, manifest = ckpt.restore_latest(tmp_path, tree(1))
    assert manifest["step"] == 10


def test_stale_latest_pointer(tmp_path):
    ckpt.save_checkpoint(tmp_path, 10, tree(1))
    (Path(tmp_path) / "LATEST").write_text("step_99999999")
    _, manifest = ckpt.restore_latest(tmp_path, tree(1))
    assert manifest["step"] == 10


def train_trees():
    """The same {"params", "opt"} tree in both packages: a bf16 and an f32
    leaf, AdamW state of each package's OptState."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    tp = {"layers": {"w": torch.from_numpy(w).to(torch.bfloat16)},
          "b": torch.from_numpy(b)}
    jp = {"layers": {"w": jnp.asarray(w).astype(jnp.bfloat16)},
          "b": jnp.asarray(b)}
    ts = opt.OptState(step=torch.tensor(5, dtype=torch.int32),
                      m=comp.tree_map(lambda p: p.float() * 0.5, tp),
                      v=comp.tree_map(lambda p: p.float().square(), tp))
    js = jopt.OptState(step=jnp.asarray(5, jnp.int32),
                       m=jax.tree_util.tree_map(
                           lambda p: p.astype(jnp.float32) * 0.5, jp),
                       v=jax.tree_util.tree_map(
                           lambda p: jnp.square(p.astype(jnp.float32)), jp))
    return {"params": tp, "opt": ts}, {"params": jp, "opt": js}


def test_checkpoints_cross_between_packages(tmp_path):
    """Each package restores the other's files: the same keys ("opt/.m/...",
    "opt/.step"), the bf16 leaves as raw V2 bytes, bit for bit."""
    ours, theirs = train_trees()
    ckpt.save_checkpoint(tmp_path / "port", 3, ours)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, theirs)
    mine = json.loads((tmp_path / "port" / "step_00000003" /
                       "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_00000003" /
                      "manifest.json").read_text())
    for k in ("keys", "shapes", "dtypes"):
        assert mine[k] == ref[k], k
    a = np.load(tmp_path / "port" / "step_00000003" / "shard_00000.npz")
    b = np.load(tmp_path / "ref" / "step_00000003" / "shard_00000.npz")
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    # the reference restores the port's file, the port the reference's
    got, _ = jckpt.restore_latest(str(tmp_path / "port"), theirs)
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(theirs)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    back, _ = ckpt.restore_latest(str(tmp_path / "ref"), ours)
    assert isinstance(back["opt"], opt.OptState)
    assert trees_equal(back, ours)


# ---------------------------------------------------------------------------
# cells, the train loop, the CLI
# ---------------------------------------------------------------------------
def smoke_cell(arch, B=2, name="smoke", **shape_kw):
    cfg = get_smoke_config(arch)
    kw = dict(seq_len=16) if cfg.family == "lm" else \
        dict(img_res=cfg.img_res)
    kw.update(shape_kw)
    S.shapes_for(cfg)[name] = ShapeSpec(name, "train", global_batch=B, **kw)
    try:
        return S.build_cell(arch, name, cfg=cfg)
    finally:
        S.shapes_for(cfg).pop(name, None)


def all_params(out):
    return list(leaves_of(out["params"])) + list(leaves_of(out["opt_state"]))


@pytest.mark.parametrize("arch", ["deit-b", "resnet-50",
                                  "granite-moe-3b-a800m"])
def test_resume_after_kill_equals_uninterrupted(tmp_path, arch):
    """6 steps with a checkpoint every 3, against 3 steps, a 'kill', and a
    resumed run to 6: every parameter and moment equal, bit for bit."""
    cell = smoke_cell(arch)
    quiet = dict(log_fn=lambda s: None, device="cpu")
    full = run(cell, TrainLoopConfig(total_steps=6, ckpt_every=3,
                                     ckpt_dir=str(tmp_path / "a"),
                                     log_every=100, seed=7), **quiet)
    run(cell, TrainLoopConfig(total_steps=3, ckpt_every=3,
                              ckpt_dir=str(tmp_path / "b"), log_every=100,
                              seed=7), **quiet)
    logs = []
    resumed = run(cell, TrainLoopConfig(total_steps=6, ckpt_every=3,
                                        ckpt_dir=str(tmp_path / "b"),
                                        log_every=100, seed=7),
                  log_fn=logs.append, device="cpu")
    assert logs[0] == "[train] resumed from step 3"
    assert int(resumed["opt_state"].step) == 6
    for x, y in zip(all_params(full), all_params(resumed)):
        assert torch.equal(x, y)


def test_resnet_checkpoints_hold_the_reference_layout(tmp_path):
    cell = smoke_cell("resnet-50")
    run(cell, TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path)),
        log_fn=lambda s: None, device="cpu")
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    for path, d in resnet.param_defs(cell.cfg).items():
        assert manifest["shapes"]["params/" + path] == list(d.shape)
        assert manifest["shapes"]["opt/.m/" + path] == list(d.shape)


def test_cli_trains_a_smoke_config(tmp_path, capsys):
    out = train_cli.main(["--arch", "granite-moe-3b-a800m", "--steps", "2",
                          "--batch", "2", "--seq", "8", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert "final loss" in capsys.readouterr().out
    assert [s for s, _ in out["losses"]] == [0, 1]
    assert np.isfinite(out["losses"][-1][1])
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
    assert "cli" not in S.shapes_for(get_smoke_config("granite-moe-3b-a800m"))


def test_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "deit-b", "--steps", "1"])


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-3b-a800m", "prefill_32k"), ("granite-moe-3b-a800m",
                                              "decode_32k"),
    ("gemma3-27b", "decode_32k"), ("deit-b", "serve_b1"),
    ("resnet-50", "serve_b1"), ("dit-xl2", "gen_fast"),
    ("unet-sd15", "gen_fast")])
def test_serve_cells_run_on_smoke_configs(arch, shape):
    """The serve / prefill / decode cells at a tiny size: the step runs on
    the factory's arguments."""
    cfg = get_smoke_config(arch)
    full = S.shapes_for(cfg)[shape]
    small = dataclasses.replace(full, name="tiny", global_batch=2,
                                seq_len=min(full.seq_len, 8) or 0,
                                img_res=(getattr(cfg, "img_res", 0)
                                         or min(full.img_res, 64)))
    S.shapes_for(cfg)["tiny"] = small
    try:
        cell = S.build_cell(arch, "tiny", cfg=cfg)
    finally:
        S.shapes_for(cfg).pop("tiny", None)
    with torch.no_grad():
        out = cell.step_fn(*cell.make_args(0, "cpu"))
    first = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(first.float()).all()
    assert cell.label == f"{arch}:tiny"
