"""A model's serve step captured as one CUDA graph per input shape — the
port's counterpart of the reference launcher's ``jax.jit(forward)``
(``repro/launch/serve.py``), which compiles once per input shape.

For a vision model an input shape is a (class resolution, batch size)
pair.  On the first call with a new shape and dtype, :class:`GraphedStep`

* allocates a static input buffer of that shape;
* runs the step on a side stream (the warm-up), so that everything done
  once per shape happens before capture: a kernel's first-use ``nvcc``
  build and module load, cuDNN's choice of algorithm, cuBLAS's workspace;
* captures one ``torch.cuda.CUDAGraph`` of the step into a memory pool
  that all of its graphs share (replays run one after another on one
  stream, so their intermediates can share memory; each graph's static
  input and output stay allocated).

Every call then copies its frames into the static input and replays.
The result is the graph's **static output buffer, which any later call
of the step may overwrite, whichever graph it replays**: the graphs share
one pool and the largest batch is captured first, so a later graph's
output can sit in an earlier graph's intermediate memory.  Read it
(``.argmax(-1).tolist()``, as ``launch.serve.make_run_batch`` does) or
clone it before the next call.

Nothing falls back: a capture or replay error propagates, and a CPU
tensor is refused (the caller runs the step eagerly there).

Replays launch the captured kernels without running their Python
wrappers, so a wrapper's launch counter (``flash_attention.launches``)
does not move on replay.  Each graph records how many ``flash_attention``
launches its capture made (:attr:`Graph.flash_launches`), and
:meth:`GraphedStep.launches` gives captured launches x replays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.kernels import flash_attention as fa

# steps run on a side stream before each capture
WARMUP_STEPS = 2


@dataclasses.dataclass
class Graph:
    """One captured step: its graph, static input and output, the
    flash_attention launches inside it, and what capturing it cost."""
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    flash_launches: int
    capture_s: float              # warm-up and capture, host wall clock
    reserved_bytes: int           # device memory the capture reserved
    replays: int = 0


class GraphedStep:
    """``step(images) -> logits`` as CUDA graph replays; ``step`` is a
    model module's ``serve_step`` with its parameters and config bound
    (:meth:`for_model`)."""

    def __init__(self, step: Callable[[torch.Tensor], torch.Tensor]):
        self.step = step
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Tuple[Tuple[int, ...], torch.dtype, str],
                          Graph] = {}

    @classmethod
    def for_model(cls, mod, params: Any, cfg) -> "GraphedStep":
        return cls(lambda images: mod.serve_step(params, images, cfg))

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        if images.device.type != "cuda":
            raise ValueError(f"GraphedStep replays CUDA graphs; got a tensor "
                             f"on {images.device} (run the step eagerly "
                             f"there)")
        key = (tuple(images.shape), images.dtype, str(images.device))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(images)
        g.static_in.copy_(images)
        g.graph.replay()
        g.replays += 1
        return g.static_out

    def _capture(self, images: torch.Tensor) -> Graph:
        dev = images.device
        t0 = time.perf_counter()
        static_in = images.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.step(static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = fa.flash_attention.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            # read inside: entering the capture empties the allocator's
            # cache, which is not this graph's memory
            reserved = torch.cuda.memory_reserved(dev)
            static_out = self.step(static_in)
        return Graph(graph, static_in, static_out,
                     fa.flash_attention.launches - before,
                     time.perf_counter() - t0,
                     torch.cuda.memory_reserved(dev) - reserved)

    def launches(self) -> int:
        """Device launches of flash_attention over every replay so far:
        each graph's captured launches x its replays."""
        return sum(g.flash_launches * g.replays
                   for g in self.graphs.values())

    def reset_counts(self) -> None:
        for g in self.graphs.values():
            g.replays = 0
