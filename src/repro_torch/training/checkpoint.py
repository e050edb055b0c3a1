"""Fault-tolerant checkpointing: npz shard + manifest, atomic commit (the
port of ``repro/training/checkpoint.py``, in the same on-disk format, so
each package restores the other's files).

Layout:
    <dir>/step_000100/
        manifest.json        # step, keys, shapes/dtypes, host count
        shard_00000.npz      # this host's param/opt leaves (flattened paths)
    <dir>/LATEST             # atomic pointer file (written last)

Leaf keys are the reference's: the path of each leaf joined by ``/``, a
dict's keys sorted (as ``jax.tree_util`` flattens them), a NamedTuple's
fields as ``.name`` (``opt/.m/...``, ``opt/.step``: how JAX prints a
``GetAttrKey``), a sequence's entries by index.  A bfloat16 leaf is
stored as the reference stores it, as raw 2-byte ``V2`` values, with
``"bfloat16"`` in the manifest; both are read and written here through
16-bit integer views, without ``ml_dtypes``.

Crash-safety: the step directory is written under a temp name and renamed
only after the shard and the manifest are fsynced; LATEST is updated via
write-to-temp + rename.  ``restore_latest`` ignores half-written step dirs,
so a job killed mid-save resumes from the previous complete checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree: PyTree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array as stored, its dtype's name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: PyTree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _paths(tree):
        flat[key], dtypes[key] = _to_numpy(leaf)
    return flat, dtypes


def _n_hosts() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def save_checkpoint(ckpt_dir: str, step: int, tree: PyTree,
                    keep_last: int = 3, host_id: int = 0,
                    extra: Optional[dict] = None) -> Path:
    base = Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat, dtypes = _flatten(tree)
    shard_path = tmp / f"shard_{host_id:05d}.npz"
    np.savez(shard_path, **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "n_hosts": _n_hosts(),
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        "extra": extra or {},
    }
    mpath = tmp / "manifest.json"
    mpath.write_text(json.dumps(manifest, indent=1))
    # fsync the directory contents before the atomic rename commit
    for p in (shard_path, mpath):
        fd = os.open(p, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    latest_tmp = base / ".LATEST.tmp"
    latest_tmp.write_text(final.name)
    latest_tmp.rename(base / "LATEST")

    _gc_old(base, keep_last)
    return final


def _gc_old(base: Path, keep_last: int) -> None:
    steps = sorted(p for p in base.glob("step_*") if p.is_dir())
    for p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)
    for p in base.glob(".tmp_step_*"):
        shutil.rmtree(p, ignore_errors=True)


def _valid(step_dir: Path) -> bool:
    m = step_dir / "manifest.json"
    if not m.exists():
        return False
    try:
        manifest = json.loads(m.read_text())
    except json.JSONDecodeError:
        return False
    shard = step_dir / "shard_00000.npz"
    return shard.exists() and "keys" in manifest


def list_checkpoints(ckpt_dir: str) -> List[Path]:
    base = Path(ckpt_dir)
    if not base.exists():
        return []
    return [p for p in sorted(base.glob("step_*")) if _valid(p)]


def _to_tensor(arr: np.ndarray, want_dtype: Optional[str]) -> torch.Tensor:
    """A stored array as a tensor of the dtype the manifest records."""
    arr = np.require(arr, requirements="C")
    if want_dtype == "bfloat16":
        # raw 2-byte values (V2 as the reference writes them)
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if want_dtype and str(arr.dtype) != want_dtype:
        arr = arr.view(np.dtype(want_dtype))
    return torch.from_numpy(arr)


def _rebuild(template: PyTree, values: Dict[str, torch.Tensor],
             prefix: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(template, Mapping):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _rebuild(getattr(template, n), values, prefix + ("." + n,))
            for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, prefix + (str(i),))
                              for i, v in enumerate(template))
    return values["/".join(prefix)]


def restore_checkpoint(step_dir: Path, template: PyTree,
                       host_id: int = 0) -> Tuple[PyTree, dict]:
    """Restore into the structure, dtypes and devices of ``template`` (a
    tree of tensors)."""
    manifest = json.loads((step_dir / "manifest.json").read_text())
    values = {}
    with np.load(step_dir / f"shard_{host_id:05d}.npz") as data:
        for key, leaf in _paths(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = _to_tensor(data[key], manifest.get("dtypes", {}).get(key))
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{tuple(t.shape)} vs template "
                                 f"{tuple(leaf.shape)}")
            values[key] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _rebuild(template, values), manifest


def restore_latest(ckpt_dir: str, template: PyTree,
                   host_id: int = 0) -> Optional[Tuple[PyTree, dict]]:
    """Restore the newest complete checkpoint, skipping corrupt ones."""
    base = Path(ckpt_dir)
    pointer = base / "LATEST"
    candidates = list_checkpoints(ckpt_dir)
    if pointer.exists():
        named = base / pointer.read_text().strip()
        if _valid(named):
            candidates = [c for c in candidates if c != named] + [named]
    for step_dir in reversed(candidates):
        try:
            return restore_checkpoint(step_dir, template, host_id)
        except (KeyError, ValueError, OSError, json.JSONDecodeError):
            continue
    return None
