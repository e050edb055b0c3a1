"""Write ``tests/data/torch_lm_golden.npz``: the JAX reference's outputs
for the language models, which ``chip_smoke.py`` (phase 4h) holds the
port's to on the card, where JAX is not installed.

Not a test (it imports JAX).  Both packages get the same inputs, made with
numpy.  Weights: ``repro_torch.models.transformer.numpy_params(cfg,
WEIGHT_SEED, constant_std=CONSTANT_STD)``, in which every leaf is random
(the norm scales, zero-initialised, are normals of std ``CONSTANT_STD``,
so a norm scaled by ``scale`` instead of ``1 + scale`` shows), each leaf
cast to the dtype its ``param_defs`` entry names (the router stays f32).

* **granite** — Granite-3.0 MoE (``repro.configs.granite_moe_3b_a800m.
  CONFIG``) at full width with its depth cut from 32 layers to
  ``GRANITE_LAYERS`` (390,233,088 parameters), in float32 and bfloat16:
  ``prefill`` of a batch of 2 prompts of ``PROMPT`` tokens
  (``default_rng(INPUT_SEED)``) into a cache of ``MAX_LEN``, then
  ``DECODE_STEPS`` ``decode_step`` calls on the fixed tokens
  ``granite/decode_tokens``; stored: the prefill's last logits
  (``prefill_logits``), each step's logits (``decode_logits``), the aux
  loss of ``hidden_states`` on the prompts (``aux``; ``decode_step``
  returns none), the layer-0 K / V cache rows at ``CACHE_ROWS`` after the
  last step (``k_rows`` / ``v_rows``), and each layer's routing of the
  prompts (``experts``, (L, B * S, top_k), from an eager pass of
  ``transformer._block`` that records ``moe.route_topk``), by which the
  card counts routing flips.  The reference's attention is its
  ``chunked`` path (``attn_chunk`` 1024, so two query chunks of 1,100
  tokens): its ``pallas`` LM path raises (the scan passes each layer's
  window traced and the Pallas kernel captures it as a constant), and
  ``chunked`` computes the same function.
* **granite_mesh** — the same Granite cut, weights and prompts through
  the reference's device-mesh path: ``launch.mesh.install_rules`` on a
  one-device CPU mesh (``make_host_mesh``, ``kind="prefill"``, global
  batch 2), which sends each MoE layer through ``moe_ffn_sharded``
  (``moe_impl="shard_map"``: the 8 padded experts masked, the capacity
  from the 40 real ones); jitted ``prefill`` (its last logits,
  ``prefill_logits``), ``logits_fn`` at the positions ``MESH_ROWS``
  (``logits_rows``, (B, 3, V)) and ``hidden_states``' aux loss (``aux``),
  in float32 and bfloat16, with the routing each of the three compiled
  calls used (``experts``, ``logits_experts``, ``aux_experts``: recorded
  inside the call by ``jax.debug.callback``), to which the card pins its
  bf16 run (a near-tie that rounds the other way moves a token's experts).
* **smoke** — the four SMOKE configs in float32 on a batch of 2 prompts of
  ``SMOKE_PROMPT`` tokens: ``logits_fn``, ``hidden_states`` and its aux,
  ``prefill`` into a cache of ``SMOKE_MAX_LEN`` (last logits, the whole
  K / V cache), then ``SMOKE_STEPS`` ``decode_step`` calls; for
  ``gemma3-smoke`` also ``SLIDING_STEPS`` ``decode_step_sliding`` calls
  from an empty sliding cache, past its window of 8.

A JSON ``meta`` entry records the seeds, ``constant_std``, the shapes and
the cut depth.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_lm_golden.py \\
        [--only granite granite_mesh smoke]

``--only`` recomputes the named sections and keeps the rest of the file.
About 4 minutes and 6 GB of host memory on a 6-core CPU, most of it the
granite and granite_mesh sections.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.configs import granite_moe_3b_a800m
from repro.distributed import sharding as shd
from repro.launch import mesh as jmesh
from repro.models import moe, transformer
from repro_torch.configs import get_smoke_config
from repro_torch.configs import granite_moe_3b_a800m as torch_granite
from repro_torch.models import common as torch_common
from repro_torch.models import transformer as torch_transformer

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_lm_golden.npz")
WEIGHT_SEED, INPUT_SEED, CONSTANT_STD = 0, 1, 0.02
DTYPES = ("float32", "bfloat16")
GRANITE_LAYERS = 2
BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 2, 1100, 1104, 4
CACHE_ROWS = (0, PROMPT - 1, MAX_LEN - 1)
MESH_ROWS = (0, PROMPT // 2, PROMPT - 1)
SMOKE_ARCHS = ("granite-moe-3b-a800m", "starcoder2-7b", "gemma3-27b",
               "kimi-k2-1t-a32b")
SMOKE_PROMPT, SMOKE_MAX_LEN, SMOKE_STEPS, SLIDING_STEPS = 12, 16, 3, 12


def reference_params(tree, defs):
    """The numpy tree as the reference's parameters: each leaf cast to the
    dtype its ``param_defs`` entry names."""
    out = {}
    for path, d in defs.items():
        torch_common.assign(out, path, jnp.asarray(
            torch_common.nested(tree, path)).astype(d.dtype))
    return out


def tokens(rng, vocab, *shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


def granite_config(dt):
    """The reference's and the port's Granite at ``GRANITE_LAYERS``."""
    kw = dict(n_layers=GRANITE_LAYERS, param_dtype=dt)
    return (dataclasses.replace(granite_moe_3b_a800m.CONFIG,
                                attn_impl="chunked", **kw),
            dataclasses.replace(torch_granite.CONFIG, **kw))


def routing(params, toks, cfg):
    """Each layer's top-k experts of the prompts, (L, B * S, K) int8: the
    reference's blocks run eagerly, one by one, with ``moe.route_topk``
    recorded."""
    seen, real = [], moe.route_topk

    def recording(logits, top_k, n_real=None):
        gates, experts = real(logits, top_k, n_real)
        seen.append(np.asarray(experts, np.int8))
        return gates, experts

    moe.route_topk = recording
    try:
        h = jnp.take(params["embed"], toks, axis=0)
        h = h * jnp.asarray(cfg.d_model ** 0.5, h.dtype)
        pos = jnp.arange(toks.shape[1])
        windows = transformer._layer_windows(cfg)
        for l in range(cfg.n_layers):
            lp = jax.tree_util.tree_map(lambda x: x[l], params["layers"])
            h, _, _ = transformer._block(h, lp, windows[l], cfg, pos)
    finally:
        moe.route_topk = real
    return np.stack(seen)


def granite_golden():
    rng = np.random.default_rng(INPUT_SEED)
    prompt = tokens(rng, torch_granite.CONFIG.vocab_size, BATCH, PROMPT)
    steps = tokens(rng, torch_granite.CONFIG.vocab_size, DECODE_STEPS, BATCH)
    arrays = {"granite/tokens": prompt, "granite/decode_tokens": steps}
    _, tcfg = granite_config("float32")
    tree = torch_transformer.numpy_params(tcfg, WEIGHT_SEED, CONSTANT_STD)
    for dt in DTYPES:
        cfg, tcfg = granite_config(dt)
        params = reference_params(tree, torch_transformer.param_defs(tcfg))
        t0 = time.time()
        prefill = jax.jit(lambda p, t: transformer.prefill(p, t, cfg,
                                                           MAX_LEN))
        decode = jax.jit(lambda p, c, t: transformer.decode_step(p, c, t,
                                                                 cfg))
        hidden = jax.jit(lambda p, t: transformer.hidden_states(p, t, cfg))
        last, cache = prefill(params, jnp.asarray(prompt))
        logits = []
        for s in steps:
            out, cache = decode(params, cache, jnp.asarray(s))
            logits.append(np.asarray(out, np.float32))
        _, aux = hidden(params, jnp.asarray(prompt))
        rows = list(CACHE_ROWS)
        p = f"granite/{dt}/"
        arrays.update({
            p + "prefill_logits": np.asarray(last, np.float32),
            p + "decode_logits": np.stack(logits),
            p + "aux": np.asarray(aux, np.float32),
            p + "k_rows": np.asarray(cache["k"][0][:, rows], np.float32),
            p + "v_rows": np.asarray(cache["v"][0][:, rows], np.float32),
            p + "experts": routing(params, jnp.asarray(prompt), cfg)})
        assert all(np.isfinite(a).all() for a in arrays.values())
        print(f"granite {dt}: {time.time() - t0:.1f} s, max |last logit| "
              f"{np.abs(arrays[p + 'prefill_logits']).max():.4f}, aux "
              f"{float(aux):.6f}", flush=True)
        del params, cache
    meta = dict(arch="granite-moe-3b-a800m", n_layers=GRANITE_LAYERS,
                cut="depth 32 -> 2 layers; full width", batch=BATCH,
                prompt=PROMPT, max_len=MAX_LEN, decode_steps=DECODE_STEPS,
                cache_rows=list(CACHE_ROWS),
                attention="chunked (the reference's pallas LM path raises)",
                n_params=sum(int(np.prod(d.shape)) for d in
                             torch_transformer.param_defs(tcfg).values()))
    return arrays, meta


def jitted_routing(fn, *args):
    """``jax.jit(fn)(*args)`` with ``moe.route_topk`` recorded inside the
    compiled call (``jax.debug.callback``, in order): its output and the
    experts (T, K) of each call, (L, B * S, K) int8 — the routing the
    jitted forward itself used, near-ties rounded its way."""
    seen, real = [], moe.route_topk

    def keep(experts):
        seen.append(np.asarray(experts, np.int8))

    def recording(logits, top_k, n_real=None):
        gates, experts = real(logits, top_k, n_real)
        jax.debug.callback(keep, experts, ordered=True)
        return gates, experts

    moe.route_topk = recording
    try:
        out = jax.block_until_ready(jax.jit(fn)(*args))
    finally:
        moe.route_topk = real
    return out, np.stack(seen)


def granite_mesh_golden():
    rng = np.random.default_rng(INPUT_SEED)
    prompt = tokens(rng, torch_granite.CONFIG.vocab_size, BATCH, PROMPT)
    arrays = {"granite_mesh/tokens": prompt}
    _, tcfg = granite_config("float32")
    tree = torch_transformer.numpy_params(tcfg, WEIGHT_SEED, CONSTANT_STD)
    rules = None
    for dt in DTYPES:
        cfg, tcfg = granite_config(dt)
        params = reference_params(tree, torch_transformer.param_defs(tcfg))
        t0 = time.time()
        rules = jmesh.install_rules(jmesh.make_host_mesh(), cfg, BATCH,
                                    kind="prefill")
        toks = jnp.asarray(prompt)
        try:
            (last, _), experts = jitted_routing(
                lambda p, t: transformer.prefill(p, t, cfg), params, toks)
            logits, logits_experts = jitted_routing(
                lambda p, t: transformer.logits_fn(p, t, cfg), params, toks)
            (_, aux), aux_experts = jitted_routing(
                lambda p, t: transformer.hidden_states(p, t, cfg), params,
                toks)
        finally:
            shd.clear_rules()
        p = f"granite_mesh/{dt}/"
        arrays.update({p + "prefill_logits": np.asarray(last, np.float32),
                       p + "logits_rows": np.asarray(
                           logits[:, list(MESH_ROWS)], np.float32),
                       p + "aux": np.asarray(aux, np.float32),
                       p + "experts": experts,
                       p + "logits_experts": logits_experts,
                       p + "aux_experts": aux_experts})
        del logits
        assert all(np.isfinite(a).all() for a in arrays.values())
        assert max(e.max() for e in (experts, logits_experts,
                                     aux_experts)) < cfg.n_experts
        print(f"granite_mesh {dt}: {time.time() - t0:.1f} s, max |last "
              f"logit| {np.abs(arrays[p + 'prefill_logits']).max():.4f}, "
              f"aux {float(aux):.6f}", flush=True)
        del params
    meta = dict(arch="granite-moe-3b-a800m", n_layers=GRANITE_LAYERS,
                cut="depth 32 -> 2 layers; full width", batch=BATCH,
                prompt=PROMPT, logits_rows=list(MESH_ROWS),
                mesh="one CPU device, (data, model) = (1, 1)",
                rules={k: v for k, v in rules.items()},
                moe="moe_ffn_sharded: padded experts masked, capacity "
                    "from n_experts",
                attention="chunked (the reference's pallas LM path raises)")
    return arrays, meta


def smoke_golden():
    arrays, meta = {}, {}
    for i, arch in enumerate(SMOKE_ARCHS):
        cfg = dataclasses.replace(jax_smoke(arch), param_dtype="float32")
        tcfg = dataclasses.replace(get_smoke_config(arch),
                                   param_dtype="float32")
        tree = torch_transformer.numpy_params(tcfg, WEIGHT_SEED + i,
                                              CONSTANT_STD)
        params = reference_params(tree, torch_transformer.param_defs(tcfg))
        rng = np.random.default_rng(INPUT_SEED + i)
        prompt = tokens(rng, cfg.vocab_size, BATCH, SMOKE_PROMPT)
        steps = tokens(rng, cfg.vocab_size, SMOKE_STEPS, BATCH)
        p = f"smoke/{cfg.name}/"
        arrays[p + "tokens"], arrays[p + "decode_tokens"] = prompt, steps
        arrays[p + "logits"] = np.asarray(
            transformer.logits_fn(params, jnp.asarray(prompt), cfg))
        h, aux = transformer.hidden_states(params, jnp.asarray(prompt), cfg)
        arrays[p + "hidden"] = np.asarray(h)
        arrays[p + "aux"] = np.asarray(aux)
        last, cache = transformer.prefill(params, jnp.asarray(prompt), cfg,
                                          SMOKE_MAX_LEN)
        arrays[p + "prefill_logits"] = np.asarray(last)
        arrays[p + "k"], arrays[p + "v"] = (np.asarray(cache[n])
                                            for n in ("k", "v"))
        logits = []
        for s in steps:
            out, cache = transformer.decode_step(params, cache,
                                                 jnp.asarray(s), cfg)
            logits.append(np.asarray(out))
        arrays[p + "decode_logits"] = np.stack(logits)
        entry = dict(weight_seed=WEIGHT_SEED + i, input_seed=INPUT_SEED + i)
        if cfg.sliding_window and cfg.global_every:
            sliding = tokens(rng, cfg.vocab_size, SLIDING_STEPS, BATCH)
            cache = transformer.init_sliding_cache(cfg, BATCH, SMOKE_MAX_LEN)
            logits = []
            for s in sliding:
                out, cache = transformer.decode_step_sliding(
                    params, cache, jnp.asarray(s), cfg)
                logits.append(np.asarray(out))
            arrays[p + "sliding_tokens"] = sliding
            arrays[p + "sliding_logits"] = np.stack(logits)
            entry["sliding_steps"] = SLIDING_STEPS
        meta[cfg.name] = entry
        print(f"smoke {cfg.name}: done", flush=True)
    return arrays, dict(archs=meta, batch=BATCH, prompt=SMOKE_PROMPT,
                        max_len=SMOKE_MAX_LEN, decode_steps=SMOKE_STEPS,
                        dtype="float32")


SECTIONS = {"granite": granite_golden, "granite_mesh": granite_mesh_golden,
           "smoke": smoke_golden}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", metavar="NAME", default=(),
                    choices=sorted(SECTIONS),
                    help="recompute these sections, keep the rest")
    only = ap.parse_args().only
    t0 = time.time()
    arrays, meta = {}, dict(weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED,
                            constant_std=CONSTANT_STD, sections={})
    if only:
        with np.load(GOLDEN) as f:
            kept = {k: f[k] for k in f.files}
        old = json.loads(str(kept.pop("meta")))
        for name in SECTIONS:
            if name not in only:
                meta["sections"][name] = old["sections"][name]
                arrays.update({k: v for k, v in kept.items()
                               if k.startswith(name + "/")})
    for name, make in SECTIONS.items():
        if not only or name in only:
            arrays_, meta["sections"][name] = make()
            arrays.update(arrays_)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, meta=np.array(json.dumps(meta)), **arrays)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes) in "
          f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
