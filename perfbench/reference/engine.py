"""Plain deadline-aware serving engine: the reference the engine's
decisions are judged by.

The paper's orchestration (Boing et al., 2022) in engine time, written
out plainly:

* each replica keeps a ledger of time blocks, one per admitted frame,
  non-overlapping, each as late as its deadline and its right neighbour
  allow.  A frame is admitted at the rightmost position whose window
  (the right neighbour's start, capped by the frame's deadline) is
  non-empty, if that window, after every earlier block is pulled left
  into its slack, still holds the frame's time; earlier blocks are then
  shifted left only as far as needed.  A frame that has used its
  forwards is appended at the tail (forced);
* a frame its replica rejects is forwarded to a neighbour drawn uniformly
  by ``random.Random(f"serving-fwd:{seed}")``, at most ``max_forwards``
  times, on a full mesh;
* each replica executes work-conservingly: when free, it pops up to
  ``max_batch`` frames from its head that have arrived and are of the
  head's class, and is busy for the class's batch time (``proc_time *
  b`` at a size the class does not list);
* before a frame is placed, every run that starts strictly before its
  arrival executes, the earliest first (the lower replica on a tie); at
  the end every queue drains.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

EPS = 1e-9


class Frame:
    __slots__ = ("fid", "cls", "arrival", "deadline", "proc", "forwards",
                 "done_at", "replica")

    def __init__(self, fid: int, cls: dict, arrival: float):
        self.fid = fid
        self.cls = cls
        self.arrival = arrival
        self.deadline = arrival + cls["deadline"]
        self.proc = cls["proc_time"]
        self.forwards = 0
        self.done_at: Optional[float] = None
        self.replica: Optional[int] = None


class Replica:
    def __init__(self, rid: int, max_batch: int):
        self.rid = rid
        self.max_batch = max_batch
        self.blocks: List[list] = []        # [start, end, frame]
        self.busy_until = 0.0
        self.stats = dict(admitted=0, rejected=0, forced=0, met=0, missed=0,
                          batches=0)

    def admit(self, fr: Frame, now: float, forced: bool) -> bool:
        free = max(now, self.busy_until)
        bl = self.blocks
        work = sum(b[1] - b[0] for b in bl)
        for j in range(len(bl), -1, -1):
            left_end = bl[j - 1][1] if j > 0 else free
            right_start = bl[j][0] if j < len(bl) else float("inf")
            cap = min(right_start, fr.deadline)
            if cap > left_end:
                if cap - (free + work) >= fr.proc - EPS:
                    self._insert(j, fr, cap)
                    return self._count(True, forced)
                break
            if j > 0:
                work -= bl[j - 1][1] - bl[j - 1][0]
        if not forced:
            return self._count(False, forced)
        start = bl[-1][1] if bl else free
        bl.append([start, start + fr.proc, fr])
        return self._count(True, forced)

    def _insert(self, j: int, fr: Frame, right: float) -> None:
        end = right - fr.proc
        for b in reversed(self.blocks[:j]):
            if b[1] <= end + EPS:
                break
            size = b[1] - b[0]
            b[1], b[0] = end, end - size
            end = b[0]
        self.blocks.insert(j, [right - fr.proc, right, fr])

    def _count(self, ok: bool, forced: bool) -> bool:
        if ok:
            self.stats["admitted"] += 1
            self.stats["forced"] += int(forced)
        else:
            self.stats["rejected"] += 1
        return ok

    def next_start(self) -> float:
        if not self.blocks:
            return float("inf")
        return max(self.busy_until, self.blocks[0][2].arrival)

    def run(self, now: float, batches: list) -> None:
        head = self.blocks[0][2].cls["name"]
        run: List[Frame] = []
        while self.blocks and len(run) < self.max_batch:
            fr = self.blocks[0][2]
            if fr.arrival > now + EPS or fr.cls["name"] != head:
                break
            run.append(self.blocks.pop(0)[2])
        cls = run[0].cls
        b = len(run)
        done = now + cls["batch_times"].get(b, cls["proc_time"] * b)
        self.busy_until = done
        self.stats["batches"] += 1
        batches.append((self.rid, head, tuple(f.fid for f in run)))
        for fr in run:
            fr.done_at = done
            fr.replica = self.rid
            self.stats["met" if done <= fr.deadline + EPS else "missed"] += 1


def serve(classes: Sequence[dict], arrivals: Sequence[float],
          cls_idx: Sequence[int], origins: Sequence[int], replicas: int,
          max_batch: int, max_forwards: int, seed: int) -> dict:
    """Serve one stream; return each frame's replica, forwards and
    completion time, the batches in execution order and the stats."""
    reps = [Replica(i, max_batch) for i in range(replicas)]
    rng = random.Random(f"serving-fwd:{seed}")
    batches: list = []
    frames: List[Frame] = []
    forwards = 0

    def advance(now: float) -> None:
        while True:
            t, rep = min(((r.next_start(), r) for r in reps),
                         key=lambda x: x[0])
            if t >= now or t == float("inf"):
                return
            rep.run(t, batches)

    for fid, (t, c, o) in enumerate(zip(arrivals, cls_idx, origins)):
        advance(t)
        fr = Frame(fid, classes[c], t)
        frames.append(fr)
        at = o
        while True:
            exhausted = fr.forwards >= max_forwards or replicas == 1
            if reps[at].admit(fr, t, forced=exhausted):
                break
            fr.forwards += 1
            forwards += 1
            at = rng.choice(tuple(i for i in range(replicas) if i != at))
    advance(float("inf"))
    stats: Dict[str, int] = {"forwards": forwards}
    for r in reps:
        for k, v in r.stats.items():
            stats[k] = stats.get(k, 0) + v
    return dict(replica=[f.replica for f in frames],
                forwards=[f.forwards for f in frames],
                done_at=[f.done_at for f in frames],
                batches=batches, stats=stats)
