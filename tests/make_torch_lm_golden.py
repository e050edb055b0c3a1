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

* **starcoder2**, **gemma3** — StarCoder2-7B and Gemma-3 27B
  (``repro.configs.{starcoder2_7b,gemma3_27b}.CONFIG``) at full width with
  their depth cut (``FULL_WIDTH``: 32 -> 2 layers, 887,118,336
  parameters; 62 -> 6, layers 0-4 local and 5 global, 5,295,902,976), in
  float32 and bfloat16 (the f32 weights cast leaf by leaf), the granite
  recipe: ``prefill`` of the same batch shape into a cache of
  ``MAX_LEN``, ``DECODE_STEPS`` ``decode_step`` calls, the layer-0 K / V
  rows at ``CACHE_ROWS``; Gemma-3 also ``DECODE_STEPS``
  ``decode_step_sliding`` calls on the same tokens from a sliding cache
  built from the prefill's full cache (``tests/lm_helpers.py::
  sliding_from_full``: ring slot ``p % 1024`` holds position ``p`` for
  ``p`` in [76, 1100), the global layer its full cache; the reference has
  no such function), and in ``meta`` how far those logits are from
  ``decode_step``'s (f32 8.0e-6; bf16 0.059, where a near-tie's argmax
  flips).  1,100 tokens pass Gemma-3's window of 1,024.  Logits are stored
  as ``lm_helpers.logit_views`` gives them: at ``COLUMNS`` vocabulary
  columns drawn from ``default_rng(COLUMN_SEED)`` (``<section>/columns``),
  and each row's largest logit, its argmax and its log-sum-exp over the
  whole vocabulary.  The weights are drawn leaf by leaf
  (``iter_numpy_params``, the same stream as ``numpy_params``), each numpy
  leaf dropped once converted.

A JSON ``meta`` entry records the seeds, ``constant_std``, the shapes and
the cut depth.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_lm_golden.py \\
        [--only granite granite_mesh smoke starcoder2 gemma3]

``--only`` recomputes the named sections and keeps the rest of the file
(a new section needs only itself).  About 4 minutes and 6 GB of host
memory on a 6-core CPU for granite, granite_mesh and smoke; on 8 cores
starcoder2 alone 52 s and 5.8 GB (peak RSS), gemma3 alone 256 s and 33.5
GB (the f32 weights are 21.2 GB).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.configs import gemma3_27b, granite_moe_3b_a800m, starcoder2_7b
from repro.distributed import sharding as shd
from repro.launch import mesh as jmesh
from repro.models import moe, transformer
from repro_torch.configs import get_smoke_config
from repro_torch.configs import gemma3_27b as torch_gemma3
from repro_torch.configs import granite_moe_3b_a800m as torch_granite
from repro_torch.configs import starcoder2_7b as torch_starcoder2
from repro_torch.models import common as torch_common
from repro_torch.models import transformer as torch_transformer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lm_helpers import logit_views, sliding_from_full  # noqa: E402

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
# the full-width dense sections: (the reference's config, the port's, the
# cut depth); Gemma-3's 6 layers keep one global layer (layers 0-4 local)
FULL_WIDTH = {"starcoder2": (starcoder2_7b.CONFIG, torch_starcoder2.CONFIG,
                             2),
              "gemma3": (gemma3_27b.CONFIG, torch_gemma3.CONFIG, 6)}
# their logits are stored at this many vocabulary columns, drawn once
# (without replacement, sorted) from default_rng(COLUMN_SEED)
COLUMNS, COLUMN_SEED = 8192, 2


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

def reference_params_by_leaf(defs, seed):
    """``reference_params`` of ``numpy_params(defs, seed, CONSTANT_STD)``
    drawn leaf by leaf (``iter_numpy_params``: the same stream), each numpy
    leaf dropped once converted: the host holds one numpy leaf beside the
    converted ones."""
    out = {}
    for path, val in torch_common.iter_numpy_params(defs, seed,
                                                    CONSTANT_STD):
        torch_common.assign(out, path,
                            jnp.asarray(val).astype(defs[path].dtype))
        del val
    return out


def cast_params(params, defs):
    """Each leaf of the reference's parameters cast to its def's dtype, in
    place, the old leaf dropped as the new one is made."""
    for path, d in defs.items():
        parts = path.split("/")
        node = params
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = node[parts[-1]].astype(d.dtype)
    return params


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def full_width_golden(name):
    """One dense model at full width with its depth cut (``FULL_WIDTH``),
    float32 then bfloat16 (the f32 weights cast leaf by leaf)."""
    jbase, tbase, layers = FULL_WIDTH[name]
    V = tbase.vocab_size
    rng = np.random.default_rng(INPUT_SEED)
    prompt = tokens(rng, V, BATCH, PROMPT)
    steps = tokens(rng, V, DECODE_STEPS, BATCH)
    columns = np.sort(np.random.default_rng(COLUMN_SEED).choice(
        V, COLUMNS, replace=False)).astype(np.int32)
    arrays = {f"{name}/tokens": prompt, f"{name}/decode_tokens": steps,
              f"{name}/columns": columns}
    sliding = bool(tbase.sliding_window and tbase.global_every)
    t0 = time.time()
    params, meta = None, {}
    for dt in DTYPES:
        cfg = dataclasses.replace(jbase, n_layers=layers, param_dtype=dt,
                                  attn_impl="chunked")
        tcfg = dataclasses.replace(tbase, n_layers=layers, param_dtype=dt)
        defs = torch_transformer.param_defs(tcfg)
        params = (reference_params_by_leaf(defs, WEIGHT_SEED)
                  if params is None else cast_params(params, defs))
        t1 = time.time()
        prefill = jax.jit(lambda p, t: transformer.prefill(p, t, cfg,
                                                           MAX_LEN))
        decode = jax.jit(lambda p, c, t: transformer.decode_step(p, c, t,
                                                                 cfg))
        last, cache = prefill(params, jnp.asarray(prompt))
        full = {n: np.asarray(cache[n]) for n in ("k", "v")}
        logits = []
        for s in steps:
            out, cache = decode(params, cache, jnp.asarray(s))
            logits.append(np.asarray(out, np.float32))
        p = f"{name}/{dt}/"
        rows = list(CACHE_ROWS)
        for key, val in (("prefill", np.asarray(last, np.float32)),
                         ("decode", np.stack(logits))):
            for view, a in logit_views(val, columns).items():
                arrays[f"{p}{key}_{view}"] = a
        arrays.update({
            p + "k_rows": np.asarray(cache["k"][0][:, rows], np.float32),
            p + "v_rows": np.asarray(cache["v"][0][:, rows], np.float32)})
        del cache
        entry = {}
        if sliding:
            # the same steps through decode_step_sliding from a sliding
            # cache built from the prefill's full cache
            sl = sliding_from_full(full["k"], full["v"], PROMPT,
                                   cfg.sliding_window, cfg.global_every)
            sl = {k: (jnp.asarray(v) if k != "length"
                      else jnp.asarray(v, jnp.int32)) for k, v in sl.items()}
            step = jax.jit(lambda p, c, t: transformer.decode_step_sliding(
                p, c, t, cfg))
            slid = []
            for s in steps:
                out, sl = step(params, sl, jnp.asarray(s))
                slid.append(np.asarray(out, np.float32))
            slid = np.stack(slid)
            for view, a in logit_views(slid, columns).items():
                arrays[f"{p}sliding_{view}"] = a
            apart = np.abs(slid - np.stack(logits))
            entry = dict(sliding_vs_full_max=float(apart.max()),
                         sliding_vs_full_rms=float(np.sqrt(
                             (apart ** 2).mean())),
                         sliding_argmax_equal=bool(
                             (slid.argmax(-1)
                              == np.stack(logits).argmax(-1)).all()))
            del sl
        del full
        assert all(np.isfinite(a).all() for a in arrays.values())
        entry["s"] = round(time.time() - t1, 1)
        meta[dt] = entry
        print(f"{name} {dt}: {time.time() - t1:.1f} s, max |last logit| "
              f"{np.abs(arrays[p + 'prefill_max']).max():.4f}, "
              f"{entry}, peak RSS {peak_rss_gb():.1f} GB", flush=True)
    del params
    n = sum(int(np.prod(d.shape)) for d in defs.values())
    meta.update(
        arch=tbase.name, n_layers=layers,
        cut=f"depth {tbase.n_layers} -> {layers} layers; full width",
        batch=BATCH, prompt=PROMPT, max_len=MAX_LEN,
        decode_steps=DECODE_STEPS, cache_rows=list(CACHE_ROWS),
        columns=COLUMNS, column_seed=COLUMN_SEED,
        attention="chunked (the reference's pallas LM path raises)",
        n_params=n, seconds=round(time.time() - t0, 1),
        peak_rss_gb=round(peak_rss_gb(), 1))
    if sliding:
        meta["sliding"] = ("decode_step_sliding from the prefill's cache "
                           "(tests/lm_helpers.py::sliding_from_full), the "
                           "decode tokens again")
    return arrays, meta


SECTIONS = {"granite": granite_golden, "granite_mesh": granite_mesh_golden,
           "smoke": smoke_golden,
           "starcoder2": lambda: full_width_golden("starcoder2"),
           "gemma3": lambda: full_width_golden("gemma3")}


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
            if name not in only and name in old["sections"]:
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
