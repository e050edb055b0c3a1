"""Wrappers of the Hopper ``fleet_feasibility`` and ``link_cost`` kernels
(``csrc/admission.cu``).

The kernels replace the TPU kernels ``repro/kernels/fleet_feasibility.py``
(``_fleet_feasibility_kernel`` / ``fleet_feasibility_fwd``) and
``repro/kernels/link_cost.py`` (``_link_cost_kernel`` / ``link_cost_fwd``);
their plain versions are :func:`repro_torch.kernels.ref.fleet_feasibility_ref`
and :func:`~repro_torch.kernels.ref.link_cost_ref`.  Bound by bytes: the
three (K, N) f32 ledgers read once, 0.94 us at K=256, N=1024 on an H100
(3.35 TB/s); one block per node row, the row staged in shared memory
(see the source's note).  ``fleet_feasibility`` is also the event heap's
``batched_feasible`` scorer (:mod:`repro_torch.orchestration.router`).
Each wrapper
checks device, dtype, shape and contiguity, allocates the outputs,
launches on PyTorch's current stream and raises on a refused launch.  It
never synchronises and never falls back: a CPU tensor is refused here
(the dispatch in :mod:`repro_torch.kernels.ops` sends those to the plain
versions).  ``fleet_feasibility.launches`` and ``link_cost.launches``
count the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

EPS = 1e-6

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "fleet_feasibility_launch": [_P] * 10 + [_I, _I, ctypes.c_float, _I, _P],
    "link_cost_launch": [_P] * 15 + [_I, _I, ctypes.c_float, _I, _P],
}


def _fn(name: str):
    fn = getattr(build.load("admission"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _ledger_specs(kernel, starts, ends, sizes, n, head, ps):
    """The device, K, N and the argument checks the two kernels share."""
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} launches on CUDA tensors, got {dev}")
    if starts.dim() != 2 or starts.shape[1] < 1:
        raise ValueError(f"{kernel}: starts must be (K, N) with N >= 1, got "
                         f"{tuple(starts.shape)}")
    K, N = starts.shape
    f32, i32 = torch.float32, torch.int32
    return dev, K, N, [
        ("starts", starts, f32, (K, N)), ("ends", ends, f32, (K, N)),
        ("sizes", sizes, f32, (K, N)), ("n", n, i32, (K,)),
        ("head", head, i32, (K,)), ("ps", ps, f32, (K,))]


def fleet_feasibility(starts: torch.Tensor, ends: torch.Tensor,
                      sizes: torch.Tensor, n: torch.Tensor, ps: torch.Tensor,
                      d: torch.Tensor, cpu_free: torch.Tensor,
                      head: torch.Tensor):
    """Launch the kernel.  ``starts``/``ends``/``sizes`` (K, N) f32 ledgers,
    ``n``/``head`` (K,) int32, ``ps``/``cpu_free`` (K,) f32, ``d`` a (1,)
    f32 device tensor (so a launch needs no host read).  Returns
    ``((K,) feasible bool, (K,) load f32)``."""
    dev, K, N, specs = _ledger_specs("fleet_feasibility", starts, ends,
                                     sizes, n, head, ps)
    f32 = torch.float32
    build.check_tensors("fleet_feasibility", dev, specs + [
        ("cpu_free", cpu_free, f32, (K,)), ("d", d, f32, (1,))])
    feas = torch.empty((K,), dtype=torch.bool, device=dev)
    load = torch.empty((K,), dtype=f32, device=dev)
    if K == 0:
        return feas, load
    err = _fn("fleet_feasibility_launch")(
        *(x.data_ptr() for x in (starts, ends, sizes, n, head, ps, cpu_free,
                                 d, feas, load)),
        K, N, EPS, *build.stream_of(dev))
    if err != 0:
        raise RuntimeError(f"fleet_feasibility launch failed: CUDA error "
                           f"{err}")
    fleet_feasibility.launches += 1
    return feas, load


def link_cost(starts: torch.Tensor, ends: torch.Tensor, sizes: torch.Tensor,
              n: torch.Tensor, ps: torch.Tensor, d: torch.Tensor,
              busy: torch.Tensor, head: torch.Tensor, t_src: torch.Tensor,
              lat_row: torch.Tensor, inv_bw_row: torch.Tensor,
              payload: torch.Tensor):
    """Launch the kernel.  As :func:`fleet_feasibility`, with ``busy``
    (K,) f32 in place of ``cpu_free``, the source's (K,) f32 latency and
    inverse-bandwidth rows, and ``d``, ``t_src``, ``payload`` (1,) f32
    device tensors.  Returns ``((K,) feasible, (K,) arrive, (K,) load)``."""
    dev, K, N, specs = _ledger_specs("link_cost", starts, ends, sizes, n,
                                     head, ps)
    f32 = torch.float32
    build.check_tensors("link_cost", dev, specs + [
        ("busy", busy, f32, (K,)), ("lat_row", lat_row, f32, (K,)),
        ("inv_bw_row", inv_bw_row, f32, (K,)), ("d", d, f32, (1,)),
        ("t_src", t_src, f32, (1,)), ("payload", payload, f32, (1,))])
    feas = torch.empty((K,), dtype=torch.bool, device=dev)
    arrive = torch.empty((K,), dtype=f32, device=dev)
    load = torch.empty((K,), dtype=f32, device=dev)
    if K == 0:
        return feas, arrive, load
    err = _fn("link_cost_launch")(
        *(x.data_ptr() for x in (starts, ends, sizes, n, head, ps, busy,
                                 lat_row, inv_bw_row, d, t_src, payload,
                                 feas, arrive, load)),
        K, N, EPS, *build.stream_of(dev))
    if err != 0:
        raise RuntimeError(f"link_cost launch failed: CUDA error {err}")
    link_cost.launches += 1
    return feas, arrive, load


fleet_feasibility.launches = 0
link_cost.launches = 0
