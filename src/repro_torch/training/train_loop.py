"""Training driver: data -> train step -> checkpoints, restartable (the
port of ``repro/training/train_loop.py``).

Fault tolerance model:

* checkpoint every ``ckpt_every`` steps (atomic, keep-last-k);
* on (re)start, resume from the newest complete checkpoint — a killed run
  loses at most ``ckpt_every`` steps;
* the data pipeline is deterministic in the step index, so restarts replay
  the exact same batches (no sample skew across failures).

The step runs eagerly on the cell's device (the reference jits it and
donates the parameters and optimizer state; the port's step updates them
in place).  The weights are drawn from ``torch.Generator(seed)`` on that
device, not the reference's: a resumed run takes them from its
checkpoint, in either package's files.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import Cell, batch_to
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import PrefetchIterator, SyntheticSource

PyTree = Any


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10
    seed: int = 0


def _save(cell: Cell, loop_cfg: TrainLoopConfig, step: int, params,
          opt_state) -> None:
    ckpt.save_checkpoint(loop_cfg.ckpt_dir, step,
                         cell.to_saved({"params": params, "opt": opt_state}),
                         keep_last=loop_cfg.keep_last)


def run(cell: Cell, loop_cfg: TrainLoopConfig,
        log_fn: Callable[[str], None] = print,
        device: DeviceLike = None) -> Dict[str, Any]:
    """Train ``cell`` (a train-kind Cell) for ``total_steps`` on ``device``
    (``None``: CUDA); resumable.  Returns the final ``params`` and
    ``opt_state``, the logged ``losses`` as (step, loss) and ``wall_s``."""
    if cell.shape.kind != "train":
        raise ValueError(f"run() needs a train cell, got {cell.label}")
    dev = resolve_device(device)
    params, opt_state, _ = cell.make_args(loop_cfg.seed, dev)

    start_step = 0
    if loop_cfg.ckpt_dir:
        template = cell.to_saved({"params": params, "opt": opt_state})
        restored = ckpt.restore_latest(loop_cfg.ckpt_dir, template)
        if restored is not None:
            tree, manifest = restored
            tree = cell.from_saved(tree)
            params, opt_state = tree["params"], tree["opt"]
            start_step = int(manifest["step"])
            log_fn(f"[train] resumed from step {start_step}")

    source = SyntheticSource(cell.arg_specs[2], seed=loop_cfg.seed)
    it = PrefetchIterator(source, start_step=start_step,
                          put_fn=lambda b: batch_to(b, dev))

    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, loop_cfg.total_steps):
            _, batch = next(it)
            params, opt_state, metrics = cell.step_fn(params, opt_state,
                                                      batch)
            if step % loop_cfg.log_every == 0 or \
                    step == loop_cfg.total_steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                log_fn(f"[train] step {step:5d} loss {loss:.4f} "
                       f"lr {float(metrics['lr']):.2e} "
                       f"gnorm {float(metrics['grad_norm']):.2f}")
            if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
                _save(cell, loop_cfg, step + 1, params, opt_state)
    finally:
        it.close()

    if loop_cfg.ckpt_dir:
        _save(cell, loop_cfg, loop_cfg.total_steps, params, opt_state)
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "wall_s": time.time() - t0}
