"""ResNet-50 (bottleneck v1.5) — the port of ``repro/models/resnet.py``.

Layout.  The reference runs NHWC activations against HWIO kernels.  The
port keeps the reference's layouts at its edges (images (B, H, W, C);
numpy trees with HWIO kernels, :func:`numpy_params`) and runs PyTorch's
convolutions on ``channels_last`` tensors inside: :func:`params_from_numpy`
permutes each kernel once to OIHW stored ``channels_last`` (O, H, W, I in
memory), and the activations are NCHW-shaped views of NHWC memory, so no
layer converts a layout.

Three of the reference's semantics the port keeps:

* **SAME padding as XLA pads it.**  ``padding="SAME"`` pads a side of
  ``n`` by ``max((ceil(n / s) - 1) s + k - n, 0)`` in all, the smaller
  half before: (0, 1) for a 3x3 window at stride 2 on an even side, where
  PyTorch's symmetric ``padding=1`` would pad (1, 1) and shift every
  window.  :func:`same_pads` is the rule; the stride-2 3x3 ``conv2`` of a
  stage's first block and the 3x3/2 max pool (padded with ``-inf``) go
  through it.
* **BatchNorm with batch statistics, in serving too.**  The reference's
  ``_bn`` takes the mean and the population variance (ddof 0) over
  (N, H, W) in f32 with eps 1e-5, whatever its module docstring says of
  running averages; so does :func:`_bn`.  A frame's logits therefore
  depend on the rest of its batch.
* **f32 is f32.**  cuDNN convolves f32 in TF32 unless told otherwise; the
  f32 forward turns that off for its duration (TF32 moves these logits by
  about 1e-3).  bf16 convolutions are unaffected.

The reference's ``shd.hint`` after each stage stands (a no-op without
rules and on plain tensors), on the NCHW view: ``(dp, tp, None, None)``
for its NHWC ``(dp, None, None, tp)``.  ``loss_fn`` and
``make_train_step`` train on batch statistics, as the reference does (and
as the port serves).  The gradients are in the port's layout; the
checkpoints of a train loop hold the reference's (``launch.steps``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ResNetConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import common

PyTree = Any
BN_EPS = 1e-5


def _stage_plan(cfg: ResNetConfig) -> List[Tuple[int, int, int, int, int]]:
    """[(n_blocks, c_in, c_mid, c_out, stride), ...] per stage."""
    w = cfg.width
    plan = []
    c_in = w
    for i, n in enumerate(cfg.depths):
        c_mid = w * (2 ** i)
        c_out = c_mid * 4
        stride = 1 if i == 0 else 2
        plan.append((n, c_in, c_mid, c_out, stride))
        c_in = c_out
    return plan


def param_defs(cfg: ResNetConfig) -> Dict[str, common.ParamDef]:
    """The reference's table: HWIO kernels and the head in the config's
    dtype, BatchNorm scales and biases in f32.  A kernel's fan-in is its
    ``shape[-2]``, the in-channels (``common._std``)."""
    dt = cfg.param_dtype
    P = common.ParamDef
    c_final = cfg.width * (2 ** (len(cfg.depths) - 1)) * 4
    defs = {
        "stem/conv": P((7, 7, cfg.in_channels, cfg.width), dtype=dt),
        "stem/bn/scale": P((cfg.width,), "ones", dtype="float32"),
        "stem/bn/bias": P((cfg.width,), "zeros", dtype="float32"),
        "head/w": P((c_final, cfg.n_classes), dtype=dt),
        "head/b": P((cfg.n_classes,), "zeros", dtype=dt),
    }
    for si, (n, c_in, c_mid, c_out, stride) in enumerate(_stage_plan(cfg)):
        for bi in range(n):
            cin = c_in if bi == 0 else c_out
            base = f"stage{si}/block{bi}"
            defs[f"{base}/conv1"] = P((1, 1, cin, c_mid), dtype=dt)
            defs[f"{base}/conv2"] = P((3, 3, c_mid, c_mid), dtype=dt)
            defs[f"{base}/conv3"] = P((1, 1, c_mid, c_out), dtype=dt)
            for j, c in ((1, c_mid), (2, c_mid), (3, c_out)):
                defs[f"{base}/bn{j}/scale"] = P((c,), "ones", dtype="float32")
                defs[f"{base}/bn{j}/bias"] = P((c,), "zeros", dtype="float32")
            if bi == 0:
                defs[f"{base}/proj"] = P((1, 1, cin, c_out), dtype=dt)
                defs[f"{base}/bnp/scale"] = P((c_out,), "ones",
                                              dtype="float32")
                defs[f"{base}/bnp/bias"] = P((c_out,), "zeros",
                                             dtype="float32")
    return defs


def to_port_layout(w: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as the port keeps it: OIHW, stored ``channels_last``
    (a permuted copy; other parameters are returned as they are)."""
    if w.dim() != 4:
        return w
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def to_reference_layout(w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_port_layout`: an OIHW kernel as HWIO."""
    return w.permute(2, 3, 1, 0) if w.dim() == 4 else w


def param_specs(cfg: ResNetConfig) -> PyTree:
    return common.param_specs(param_defs(cfg))


def param_logical(cfg: ResNetConfig) -> Dict[str, Tuple]:
    """Logical sharding axes aligned with ``param_defs`` paths (the
    reference's HWIO kernels, as checkpoints hold them)."""
    log: Dict[str, Tuple] = {}
    for path, d in param_defs(cfg).items():
        if path.endswith(("scale", "bias")) or path == "head/b":
            log[path] = tuple(None for _ in d.shape)
        elif path == "head/w":
            log[path] = ("fsdp", "tp")
        else:   # conv kernels: shard output channels
            log[path] = tuple([None] * (len(d.shape) - 1) + ["tp"])
    return log


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> PyTree:
    """Random weights from a ``torch.Generator`` (not the reference's
    numbers: use :func:`numpy_params` to share weights with it), in the
    port's layout."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    tree = common.init_params(param_defs(cfg), generator, "cpu")
    for path in param_defs(cfg):
        common.assign(out, path,
                      to_port_layout(common.nested(tree, path)).to(dev))
    return out


def numpy_params(cfg: ResNetConfig, seed: int) -> PyTree:
    """Seeded f32 numpy weights in the reference's layout (HWIO); the card
    and the golden generator build identical weights from them without
    JAX."""
    return common.numpy_params(param_defs(cfg), seed)


def params_from_numpy(tree: Mapping, cfg: ResNetConfig,
                      device: DeviceLike = None) -> PyTree:
    """The reference's parameter tree (nested dict of numpy arrays, or of
    anything ``np.asarray`` reads, HWIO kernels) as the port's parameters:
    each checked against :func:`param_defs`, cast to its def's dtype, the
    kernels in the port's layout (:func:`to_port_layout`), on ``device``."""
    return common.params_from_numpy(param_defs(cfg), tree, cfg.name, device,
                                    layout=to_port_layout)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` along one side of ``n`` for a window ``k``
    at stride ``s``: (before, after), the smaller half before."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` padded as SAME pads it where XLA's padding is asymmetric, and
    the symmetric padding left for the op itself to apply."""
    (h0, h1), (w0, w1) = same_pads(x.shape[2], k, s), same_pads(x.shape[3],
                                                                 k, s)
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    x, pad = _same(x, w.shape[-1], stride)
    return F.conv2d(x, w, stride=stride, padding=pad)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """The reference's 3x3/2 ``reduce_window`` max with ``-inf`` and
    ``"SAME"``."""
    x, pad = _same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, 2, padding=pad)


def _bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = BN_EPS) -> torch.Tensor:
    """Batch statistics over (N, H, W) in f32, population variance, cast
    back to ``x``'s dtype — the reference's ``_bn``."""
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=(0, 2, 3), correction=0, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float()[:, None, None]
            + bias.float()[:, None, None]).to(x.dtype)


@contextlib.contextmanager
def _exact_f32(dtype: torch.dtype):
    """cuDNN's f32 convolutions in f32, not TF32, while an f32 forward
    runs (restored after)."""
    if dtype != torch.float32:
        yield
        return
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def forward(params: PyTree, images: torch.Tensor, cfg: ResNetConfig
            ) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, n_classes) in f32, on the
    parameters' device."""
    dt = common.torch_dtype(cfg.param_dtype)
    with _exact_f32(dt):
        # NHWC memory viewed as NCHW: a channels_last tensor
        x = images.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        stem = params["stem"]
        x = F.conv2d(x, stem["conv"], stride=2, padding=3)
        x = torch.relu(_bn(x, stem["bn"]["scale"], stem["bn"]["bias"]))
        x = _max_pool(x)
        for si, (n, _, _, _, stride) in enumerate(_stage_plan(cfg)):
            for bi in range(n):
                bp = params[f"stage{si}"][f"block{bi}"]
                s = stride if bi == 0 else 1
                y = torch.relu(_bn(_conv(x, bp["conv1"]), **bp["bn1"]))
                y = torch.relu(_bn(_conv(y, bp["conv2"], s), **bp["bn2"]))
                y = _bn(_conv(y, bp["conv3"]), **bp["bn3"])
                sc = _bn(_conv(x, bp["proj"], s), **bp["bnp"]) if bi == 0 \
                    else x
                x = torch.relu(y + sc)
            x = shd.hint(x, "dp", "tp", None, None)
        feat = x.float().mean(dim=(2, 3))
        return feat @ params["head"]["w"].float() + params["head"]["b"].float()


def serve_step(params: PyTree, images: torch.Tensor, cfg: ResNetConfig
               ) -> torch.Tensor:
    return forward(params, images, cfg)


def loss_fn(params: PyTree, batch: Dict[str, torch.Tensor],
            cfg: ResNetConfig):
    """(xent, {"loss", "accuracy"}) of a batch of ``images`` (B, H, W, C)
    and ``labels`` (B,)."""
    logits = forward(params, batch["images"], cfg)
    loss = common.softmax_xent(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def make_train_step(cfg: ResNetConfig, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of :func:`loss_fn` and one AdamW update,
    applied in place (:func:`common.make_train_step`)."""
    return common.make_train_step(loss_fn, cfg, opt_cfg)
