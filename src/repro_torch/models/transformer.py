"""Decoder-only transformer LM (dense / MoE, GQA, RoPE, sliding-window):
the port of ``repro/models/transformer.py``'s serving path.

Covers four architectures: kimi-k2-1t-a32b, granite-moe-3b-a800m,
starcoder2-7b, gemma3-27b.  Layer weights are stacked on a leading ``L``
axis as in the reference, so :func:`numpy_params` carries one set of numpy
weights into either package; the reference's ``lax.scan`` over layers is
a Python loop over ``params["layers"][name][l]`` (contiguous slices).

* ``hidden_states`` / ``logits_fn`` — the forward.
* ``make_train_step``  — forward + chunked-vocab loss + AdamW.
* ``prefill``          — forward returning the filled KV cache + last logits.
* ``decode_step``      — one token against a full KV cache.
* ``decode_step_sliding`` — gemma3 path: ring-buffer window caches for local
  layers, full caches only for the 1-in-6 global layers.

The reference is functional and donates its cache; here the decode steps
write the new K / V rows into the cache's tensors **in place** (a copy of a
full-length cache per step would not fit beside it) and return a new dict
with the same tensors and ``length + 1``.  A cache's ``length`` is a Python
int.

Port choices (the functions are the reference's): every RMS norm goes
through :func:`repro_torch.kernels.ops.rmsnorm` and the MoE's expert
products through ``ops.moe_gemm`` (:mod:`.moe`), the hand-written Hopper
kernels on the card and their plain versions on the CPU, where the
reference calls jnp ``rms_norm`` and einsums.  Attention past
``attn_chunk`` tokens with ``attn_impl="pallas"`` runs the flash kernel,
with each layer's window as an int (``NO_WINDOW`` for full causal).  The
reference's own ``pallas`` LM path raises (its scan passes the window
traced, and its Pallas kernel captures it as a constant), so the
reference that the kernel path is held against is its ``chunked`` path,
the same function.  Training differentiates the same code: both kernels
carry gradients (``ops.RMSNormFn``, ``ops.MoEGemmFn``); the flash kernel
has no backward (neither has the reference's), and the published configs
train on the ``chunked`` path.  With ``cfg.remat`` each layer is
recomputed in the backward (the reference's ``jax.checkpoint`` on its
scan body).

Distribution: ``param_specs`` / ``param_logical`` and the cache logicals
are the reference's tables.  With a device mesh installed
(``launch.mesh.install_rules``) a ``moe_impl="shard_map"`` config's MoE
layers run :func:`moe.moe_ffn_sharded` on the installed rules, as the
reference's ``_ffn`` does (Granite's 8 padded experts then masked); the
rest of the forward runs on each rank's whole tensors.  The reference's
activation and cache hints (``shd.hint``) stand where its stand: no-ops
on plain tensors, the dry run's constraints on a mesh
(:mod:`repro_torch.launch.op_cost`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import common, moe

PyTree = Any
NO_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def param_defs(cfg: LMConfig) -> Dict[str, common.ParamDef]:
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, KV, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    dt = cfg.param_dtype
    P = common.ParamDef
    defs = {
        # the reference's "embed" init draws a normal as "normal" does
        "embed": P((V, d), dtype=dt),
        "final_norm": P((d,), "zeros", dtype=dt),
        "lm_head": P((d, V), dtype=dt),
        "layers/ln1": P((L, d), "zeros", dtype=dt),
        "layers/ln2": P((L, d), "zeros", dtype=dt),
        "layers/wq": P((L, d, H * hd), dtype=dt),
        "layers/wk": P((L, d, KV * hd), dtype=dt),
        "layers/wv": P((L, d, KV * hd), dtype=dt),
        "layers/wo": P((L, H * hd, d), dtype=dt),
    }
    if cfg.moe:
        E = cfg.n_experts_eff
        defs.update({
            "layers/router": P((L, d, E), dtype="float32"),
            "layers/we_gate": P((L, E, d, f), dtype=dt),
            "layers/we_up": P((L, E, d, f), dtype=dt),
            "layers/we_down": P((L, E, f, d), dtype=dt),
        })
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            defs.update({
                "layers/ws_gate": P((L, d, fs), dtype=dt),
                "layers/ws_up": P((L, d, fs), dtype=dt),
                "layers/ws_down": P((L, fs, d), dtype=dt),
            })
    else:
        defs["layers/w_gate"] = P((L, d, f), dtype=dt)
        if not cfg.mlp_gelu():
            defs["layers/w_up"] = P((L, d, f), dtype=dt)
        defs["layers/w_down"] = P((L, f, d), dtype=dt)
    return defs


def param_specs(cfg: LMConfig) -> PyTree:
    return common.param_specs(param_defs(cfg))


def param_logical(cfg: LMConfig) -> Dict[str, Tuple]:
    """Logical sharding axes aligned with ``param_defs`` paths."""
    log = {
        "embed": ("tp", "fsdp"),
        "final_norm": (None,),
        "lm_head": ("fsdp", "tp"),
        "layers/ln1": (None, None),
        "layers/ln2": (None, None),
        "layers/wq": (None, "fsdp", "tp"),
        # kv projections shard over tp only when n_kv_heads divides the tp
        # size (the 'tp_kv' rule, installed per mesh)
        "layers/wk": (None, "fsdp", "tp_kv"),
        "layers/wv": (None, "fsdp", "tp_kv"),
        "layers/wo": (None, "tp", "fsdp"),
    }
    if cfg.moe:
        if cfg.moe_shard_mode() == "expert":
            log.update({
                "layers/router": (None, "fsdp", None),
                "layers/we_gate": (None, "tp", "fsdp", None),
                "layers/we_up": (None, "tp", "fsdp", None),
                "layers/we_down": (None, "tp", None, "fsdp"),
            })
        else:   # shard each expert's hidden dim instead (E not divisible)
            log.update({
                "layers/router": (None, "fsdp", None),
                "layers/we_gate": (None, None, "fsdp", "tp"),
                "layers/we_up": (None, None, "fsdp", "tp"),
                "layers/we_down": (None, None, "tp", "fsdp"),
            })
        if cfg.n_shared_experts:
            log.update({
                "layers/ws_gate": (None, "fsdp", "tp"),
                "layers/ws_up": (None, "fsdp", "tp"),
                "layers/ws_down": (None, "tp", "fsdp"),
            })
    else:
        log["layers/w_gate"] = (None, "fsdp", "tp")
        if not cfg.mlp_gelu():
            log["layers/w_up"] = (None, "fsdp", "tp")
        log["layers/w_down"] = (None, "tp", "fsdp")
    return log


def init_params(cfg: LMConfig, generator: torch.Generator,
                device: DeviceLike = None) -> PyTree:
    """Random weights from a ``torch.Generator`` (not the reference's
    numbers: use :func:`numpy_params` to share weights with it); a
    generator on the card draws them there."""
    return common.init_params(param_defs(cfg), generator, device)


def numpy_params(cfg: LMConfig, seed: int,
                 constant_std: Optional[float] = None) -> PyTree:
    """Seeded f32 numpy weights in the reference's stacked layout; with
    ``constant_std`` every leaf random (``common.numpy_params``: the norm
    scales otherwise all start at 0, i.e. a factor of 1)."""
    return common.numpy_params(param_defs(cfg), seed, constant_std)


def params_from_numpy(tree: Mapping, cfg: LMConfig,
                      device: DeviceLike = None) -> PyTree:
    """The reference's parameter tree as tensors of each def's dtype
    (``cfg.param_dtype``; the router f32) on ``device`` (``None``: CUDA),
    each checked against :func:`param_defs`."""
    return common.params_from_numpy(param_defs(cfg), tree, cfg.name, device)


def _layer_windows(cfg: LMConfig) -> List[int]:
    """Per-layer attention window (NO_WINDOW = full causal)."""
    if cfg.sliding_window is None:
        return [NO_WINDOW] * cfg.n_layers
    if cfg.global_every > 0:
        return [NO_WINDOW if (i + 1) % cfg.global_every == 0
                else cfg.sliding_window for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def layer_is_global(cfg: LMConfig) -> torch.Tensor:
    idx = torch.arange(cfg.n_layers)
    if cfg.sliding_window is None:
        return torch.ones(cfg.n_layers, dtype=torch.bool)
    if cfg.global_every:
        return (idx + 1) % max(1, cfg.global_every) == 0
    return torch.zeros(cfg.n_layers, dtype=torch.bool)


def _layer(params: PyTree, l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s weights: a view of each stacked leaf (or its ``l``-th
    entry, where a leaf is a list of layers: ``common.value_and_grad``)."""
    return {name: w[l] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _embed(params: PyTree, tokens: torch.Tensor, cfg: LMConfig
           ) -> torch.Tensor:
    """Embedding rows scaled by sqrt(d_model), the constant rounded to the
    activations' dtype first as the reference's ``jnp.asarray(d ** 0.5,
    h.dtype)`` does (39.25 in bf16 for d = 1536).  ``common.embedding``
    is the reference's ``jnp.take`` (a gather) with its gradient: each
    token id's rows summed in row order in the table's dtype, as XLA's
    scatter-add sums them (``F.embedding``'s backward sums in f32)."""
    h = common.embedding(params["embed"], tokens).to(
        common.torch_dtype(cfg.param_dtype))
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)


def _qkv(x, lp, cfg: LMConfig, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ lp["wq"]).reshape(B, S, H, hd)
    k = (x @ lp["wk"]).reshape(B, S, KV, hd)
    v = (x @ lp["wv"]).reshape(B, S, KV, hd)
    q = attn.apply_rope(q, positions, cfg.rope_theta)
    k = attn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(x2, lp, cfg: LMConfig):
    """Returns (out, aux_loss). x2: (B, S, d)."""
    B, S, d = x2.shape
    if not cfg.moe:
        g = x2 @ lp["w_gate"]
        if cfg.mlp_gelu():
            h = common.gelu(g)
        else:
            h = common.swiglu(g, x2 @ lp["w_up"])
        return h @ lp["w_down"], torch.zeros((), device=x2.device)
    flat = x2.reshape(B * S, d)
    mesh = shd.active_mesh()
    if cfg.moe_impl == "shard_map" and mesh is not None:
        rules = shd.get_rules()
        dp = rules.get("dp")
        dp_axes = (dp,) if isinstance(dp, str) else dp
        out, aux = moe.moe_ffn_sharded(
            flat, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            mesh=mesh, dp_axes=dp_axes, model_axis=rules.get("tp", "model"),
            fsdp_axes=rules.get("fsdp"),
            expert_sharded=cfg.moe_shard_mode() == "expert",
            n_real=cfg.n_experts)
    else:
        out, aux = moe.moe_ffn(flat, lp["router"], lp["we_gate"],
                               lp["we_up"], lp["we_down"], top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               n_real=cfg.n_experts)
    if cfg.n_shared_experts:
        h = common.swiglu(flat @ lp["ws_gate"], flat @ lp["ws_up"])
        out = out + h @ lp["ws_down"]
    return out.reshape(B, S, d), aux


def _block(h, lp, window: int, cfg: LMConfig, positions):
    """One transformer layer. Returns (h, aux, (k, v))."""
    B, S, _ = h.shape
    x = kops.rmsnorm(h, lp["ln1"])
    q, k, v = _qkv(x, lp, cfg, positions)
    o = attn.attention(q, k, v, causal=True, window=window,
                       impl=cfg.attn_impl, q_chunk=cfg.attn_chunk)
    h = shd.hint(h + o.reshape(B, S, -1) @ lp["wo"], "dp", None, None)
    f, aux = _ffn(kops.rmsnorm(h, lp["ln2"]), lp, cfg)
    return shd.hint(h + f, "dp", None, None), aux, (k, v)


def _head(params: PyTree, h: torch.Tensor) -> torch.Tensor:
    """Logits in f32 from the last norm's output: the bf16 (or f32) inputs
    upcast and contracted in f32, the reference's
    ``preferred_element_type=f32`` (no rounding to the weights' dtype; the
    caller keeps TF32 off on the card)."""
    return h.float() @ params["lm_head"].float()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def hidden_states(params: PyTree, tokens: torch.Tensor, cfg: LMConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> ((B, S, d) hidden, scalar aux loss)."""
    S = tokens.shape[1]
    h = shd.hint(_embed(params, tokens, cfg), "dp", None, None)
    positions = torch.arange(S, device=h.device)
    aux = torch.zeros((), device=h.device)
    for l, window in enumerate(_layer_windows(cfg)):
        lp = _layer(params, l)

        def body(h, lp=lp, window=window):
            return _block(h, lp, window, cfg, positions)[:2]

        h, a = common.checkpointed(body, h) if cfg.remat else body(h)
        aux = aux + a
    return kops.rmsnorm(h, params["final_norm"]), aux


def logits_fn(params: PyTree, tokens: torch.Tensor, cfg: LMConfig
              ) -> torch.Tensor:
    """(B, S) tokens -> (B, S, V) f32 logits."""
    h, _ = hidden_states(params, tokens, cfg)
    return _head(params, h)


def _chunk_xent(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """Summed xent of one chunk: f32 logits (the inputs upcast, as
    ``_head``), logsumexp minus the gold logit."""
    logits = shd.hint(h.float() @ head.float(), "dp", None, "tp")
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).sum()


def chunked_lm_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Mean xent without materialising (B, S, V): the sequence in
    ``chunk``-token chunks, each checkpointed under grad (its logits
    recomputed in the backward), summed in order; the ``S % chunk``
    tokens left over as one more, unchecked chunk, as the reference's
    ``chunked_lm_loss`` does after its scan."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        tot = tot + common.checkpointed(_chunk_xent, h[:, sl], head,
                                        labels[:, sl])
    if S - n * chunk:
        tot = tot + _chunk_xent(h[:, n * chunk:], head, labels[:, n * chunk:])
    return tot / (B * S)


def loss_fn(params: PyTree, batch: Dict[str, torch.Tensor], cfg: LMConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss + 0.01 aux, {"loss", "aux_loss"}) of a batch of ``tokens``
    and ``labels`` (B, S)."""
    h, aux = hidden_states(params, batch["tokens"], cfg)
    loss = chunked_lm_loss(h, params["lm_head"], batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


def make_train_step(cfg: LMConfig, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of :func:`loss_fn` and one AdamW update,
    applied in place (:func:`common.make_train_step`)."""
    return common.make_train_step(loss_fn, cfg, opt_cfg)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------
def cache_specs(cfg: LMConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """Shape and dtype of each cache entry (``length`` a Python int)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt = common.torch_dtype(cfg.param_dtype)
    return {"k": (shape, dt), "v": (shape, dt), "length": ((), int)}


def cache_logical() -> Dict[str, Tuple]:
    # 'cache_seq' / 'cache_kv' are installed per (mesh, config): KV-head
    # sharding when n_kv_heads divides the model axis, else the sequence
    return {"k": (None, "dp", "cache_seq", "cache_kv", None),
            "v": (None, "dp", "cache_seq", "cache_kv", None),
            "length": ()}


def _zeros(specs: Dict[str, Any], dev) -> Dict[str, Any]:
    return {name: 0 if dt is int else torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in specs.items()}


def _hint_cache(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's hints on a cache's K / V (``cache_logical``): the
    same dict (the tensors themselves) without rules."""
    spec = cache_logical()["k"]
    return dict(cache, k=shd.hint(cache["k"], *spec),
                v=shd.hint(cache["v"], *spec))


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    return _zeros(cache_specs(cfg, batch, max_len), resolve_device(device))


def prefill(params: PyTree, tokens: torch.Tensor, cfg: LMConfig,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward pass that also returns the KV cache (zero past S up to
    ``max_len``) and the last position's (B, V) f32 logits."""
    B, S = tokens.shape
    max_len = max_len or S
    h = shd.hint(_embed(params, tokens, cfg), "dp", None, None)
    cache = _hint_cache(init_cache(cfg, B, max_len, h.device))
    positions = torch.arange(S, device=h.device)
    for l, window in enumerate(_layer_windows(cfg)):
        h, _, (k, v) = _block(h, _layer(params, l), window, cfg, positions)
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
    h = kops.rmsnorm(h[:, -1:].contiguous(), params["final_norm"])
    cache["length"] = S
    return _head(params, h[:, 0]), cache


def _decode_layer(h, lp, cfg: LMConfig, positions, k_l, v_l, slot: int,
                  n_valid: int, window: Optional[int]):
    """One layer of a decode step: the new K / V row written in place at
    ``slot`` of the layer's caches, attention over their first
    ``n_valid`` entries (within ``window``)."""
    B = h.shape[0]
    q, k_new, v_new = _qkv(kops.rmsnorm(h, lp["ln1"]), lp, cfg, positions)
    k_l[:, slot] = k_new[:, 0]
    v_l[:, slot] = v_new[:, 0]
    o = attn.attention_decode(q, k_l, v_l, n_valid, window=window)
    h = h + o.reshape(B, 1, -1) @ lp["wo"]
    f, _ = _ffn(kops.rmsnorm(h, lp["ln2"]), lp, cfg)
    return h + f


def _decode_input(params, cache, tokens, cfg):
    pos = int(cache["length"])
    h = _embed(params, tokens, cfg)[:, None, :]
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
    return pos, h, positions


def decode_step(params: PyTree, cache: Dict[str, Any], tokens: torch.Tensor,
                cfg: LMConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B,) -> (logits (B, V) f32, the cache with
    the step's K / V written in place at ``length`` and ``length + 1``)."""
    pos, h, positions = _decode_input(params, cache, tokens, cfg)
    for l, window in enumerate(_layer_windows(cfg)):
        h = _decode_layer(h, _layer(params, l), cfg, positions,
                          cache["k"][l], cache["v"][l], pos, pos + 1, window)
    h = kops.rmsnorm(h, params["final_norm"])
    return _head(params, h[:, 0]), dict(_hint_cache(cache), length=pos + 1)


# ---------------------------------------------------------------------------
# Sliding-window decode (gemma3): ring-buffer caches for local layers
# ---------------------------------------------------------------------------
def sliding_cache_specs(cfg: LMConfig, batch: int, max_len: int
                        ) -> Dict[str, Any]:
    assert cfg.sliding_window and cfg.global_every
    W = cfg.sliding_window
    KV, hd = cfg.n_kv_heads, cfg.hd
    n_global = cfg.n_layers // cfg.global_every
    n_local = cfg.n_layers - n_global
    dt = common.torch_dtype(cfg.param_dtype)
    return {
        "k_global": ((n_global, batch, max_len, KV, hd), dt),
        "v_global": ((n_global, batch, max_len, KV, hd), dt),
        "k_local": ((n_local, batch, W, KV, hd), dt),
        "v_local": ((n_local, batch, W, KV, hd), dt),
        "length": ((), int),
    }


def sliding_cache_logical() -> Dict[str, Tuple]:
    return {"k_global": (None, "dp", "cache_seq", "cache_kv", None),
            "v_global": (None, "dp", "cache_seq", "cache_kv", None),
            "k_local": (None, "dp", None, "cache_kv", None),
            "v_local": (None, "dp", None, "cache_kv", None),
            "length": ()}


def init_sliding_cache(cfg: LMConfig, batch: int, max_len: int,
                       device: DeviceLike = None) -> Dict[str, Any]:
    return _zeros(sliding_cache_specs(cfg, batch, max_len),
                  resolve_device(device))


def decode_step_sliding(params: PyTree, cache: Dict[str, Any],
                        tokens: torch.Tensor, cfg: LMConfig
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """gemma3 long-context decode: local layers touch only their W-token
    ring buffers (slot ``length % W``; every slot below ``min(length + 1,
    W)`` is valid, and their order does not matter to the softmax), the
    global ones (every ``global_every``-th layer) their full caches, so a
    step's compute and memory are O(n_global * S + n_local * W).  The
    layers run in their own order, which is the reference's (its locals
    before each global, then the trailing locals)."""
    assert cfg.sliding_window and cfg.global_every
    W = cfg.sliding_window
    pos, h, positions = _decode_input(params, cache, tokens, cfg)
    ring, n_ring = pos % W, min(pos + 1, W)
    li = gi = 0
    for l, window in enumerate(_layer_windows(cfg)):
        is_global = window == NO_WINDOW
        if is_global:
            k_l, v_l = cache["k_global"][gi], cache["v_global"][gi]
            slot, n_valid, gi = pos, pos + 1, gi + 1
        else:
            k_l, v_l = cache["k_local"][li], cache["v_local"][li]
            slot, n_valid, li = ring, n_ring, li + 1
        h = _decode_layer(h, _layer(params, l), cfg, positions, k_l, v_l,
                          slot, n_valid, None)
    h = kops.rmsnorm(h, params["final_norm"])
    return _head(params, h[:, 0]), dict(cache, length=pos + 1)
