"""Deadline-aware preferential queue — Algorithms 1-5 of Boing et al. (2022)
(the port's copy of ``repro/core/block_queue.py``; host Python, as in the
reference).

The queue is a ledger of non-overlapping *time blocks* on the node's CPU
timeline.  Every admitted request ``R`` owns one block ``[start, end]`` with
``end - start == R.proc_time`` and ``end <= R.deadline`` (absolute).  Blocks
are kept *as late as feasible* (right-aligned at
``min(right_neighbor.start, deadline)``), which creates the free time-gaps of
the paper's Figs. 1-2 that later, tighter-deadline requests can slot into.

Semantics reconstructed from the paper (see DESIGN.md §2):

* ``push`` scans tail → head for the *rightmost feasible* insertion position.
  Position ``j`` (between blocks ``j-1`` and ``j``) is feasible iff

      min(starts[j], d_new) - (cpu_free + prefix_work[j]) >= p_new

  i.e. the window capped by the new deadline, after left-compacting every
  earlier block into its cumulative slack, still fits the new block.  This is
  exactly what the incremental ``_freeNeeded`` recursion of the paper's
  Alg. 2 computes (gap widths accumulated while recursing left).
* On success the new block is right-aligned in its window and earlier blocks
  are left-shifted only as much as needed (the Fig. 2c-d cascade: "the
  available spaces between R1-R2 and R2-R3 are reduced").  Left shifts never
  violate a deadline (ends only decrease) and never cross ``cpu_free`` (the
  feasibility test bounds the cascade by the compacted prefix).
* ``forced`` push (request exhausted its M forwards): the whole queue is
  compacted left ("all available time slots will be removed", Fig. 3) and the
  block is appended at the tail — late, but no *other* admitted deadline is
  disturbed.

The executor is work-conserving: ``pop`` hands out the head block immediately
when the CPU frees, so real completions only ever beat the ledger (the ledger
is a conservative admission-control commitment; invariant argued in
DESIGN.md §2).

Two interchangeable implementations:

* :class:`PreferentialQueue` — faithful tail→head linear scan, mirroring the
  paper's linked-list recursion (converted to iteration so queue depth is not
  bounded by the Python recursion limit).  O(n) per push.
* :class:`FastPreferentialQueue` — beyond-paper O(log n) feasibility search
  exploiting that cumulative slack ``S_j`` is monotone in ``j`` (derivation
  in DESIGN.md).  Observationally identical — property-tested against the
  faithful queue in ``tests/test_block_queue.py``.
"""
from __future__ import annotations

import bisect
from typing import List, Optional

from repro_torch.core.request import Request

_EPS = 1e-9


class Block:
    """One scheduled request occupying ``[start, end]`` on the CPU timeline."""

    __slots__ = ("request", "start", "end")

    def __init__(self, request: Request, start: float, end: float):
        self.request = request
        self.start = start
        self.end = end

    @property
    def size(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Block(r{self.request.rid}, [{self.start:.1f}, {self.end:.1f}], "
                f"d={self.request.deadline:.1f})")


class PreferentialQueue:
    """Paper-faithful preferential queue (Algorithms 1-5).

    ``forced_compaction`` selects between two readings of the paper's forced
    push ("R_new must be allocated at the end of the queue, and all available
    time slots will be removed"):

    * ``False`` (default) — the slots are removed *from consideration*: the
      forced block is appended plainly at the tail and the existing gap
      structure survives.  This reading reproduces the paper's Fig. 5/6
      results (preferential > FIFO on both metrics).
    * ``True`` — the literal Alg. 2 pseudo-code reading: the whole queue is
      physically compacted left before appending.  This destroys all gaps;
      under sustained overload (where forced pushes are frequent) it
      degenerates the preferential queue to FIFO behaviour and *cannot*
      reproduce the paper's reported gains.  Kept for the ablation in
      EXPERIMENTS.md §Paper-reproduction.
    """

    def __init__(self, forced_compaction: bool = False) -> None:
        self._blocks: List[Block] = []
        self._total_work = 0.0
        self.forced_compaction = forced_compaction

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._blocks)

    def is_empty(self) -> bool:
        return not self._blocks

    @property
    def blocks(self) -> List[Block]:
        return self._blocks

    def pending_work(self) -> float:
        return self._total_work

    def check_invariants(self, cpu_free_time: float = float("-inf")) -> None:
        """Raise AssertionError if the ledger is inconsistent (test hook)."""
        prev_end = cpu_free_time
        for b in self._blocks:
            assert b.start >= prev_end - 1e-6, f"overlap/out-of-order at {b}"
            assert abs(b.size - b.request.proc_time) < 1e-6, f"bad size at {b}"
            prev_end = b.end

    def scheduled_blocks(self, cpu_free_time: float = 0.0):
        """(start, end) per admitted block — the ledger the router's
        ``batched_feasible`` policy scores against (gaps included)."""
        return [(b.start, b.end) for b in self._blocks]

    def scheduled_late(self) -> int:
        """Number of blocks scheduled past their deadline (forced pushes only)."""
        return sum(1 for b in self._blocks if b.end > b.request.deadline + _EPS)

    def deadlines_respected(self) -> bool:
        """True iff every block's scheduled end is within its deadline."""
        return self.scheduled_late() == 0

    # -- Algorithm 1: push_request ------------------------------------------
    def push(self, request: Request, cpu_free_time: float, forced: bool = False) -> bool:
        p = request.proc_time
        d = request.deadline
        blocks = self._blocks
        n = len(blocks)

        # search_alloc_space (Alg. 2), iteratively, tail → head.  ``pw`` is
        # the prefix work left of the candidate position (the paper tracks the
        # complementary quantity ``_freeNeeded`` while recursing).
        placed = self._search_alloc_space(p, d, cpu_free_time)
        if placed is not None:
            j, window_right = placed
            self._insert_with_shift(j, request, window_right)
            self._total_work += p
            return True

        if not forced:
            return False

        # Forced push (Alg. 1 lines 11-18): append at the tail, ignoring the
        # gap structure.  Optionally compact first (see class docstring).
        if self.forced_compaction:
            self._compact_all(cpu_free_time)
        start = blocks[-1].end if blocks else cpu_free_time
        blocks.append(Block(request, start, start + p))
        self._total_work += p
        return True

    def _search_alloc_space(self, p: float, d: float, cpu_free_time: float):
        """Find the insertion slot: ``(position, window_right)`` or ``None``.

        The paper's Alg. 2 walks tail → head until it reaches the rightmost
        position whose useful area (Alg. 3) is non-empty — i.e. the window
        right edge ``min(right.start, d)`` exceeds the left neighbour's end.
        The new block is placed right-aligned there; any deficit must be
        covered by slack strictly to the left (cumulative-gap feasibility:
        ``cap - (cpu_free + prefix_work) >= p``).  Blocks to the *right* of
        the slot are never moved (Fig. 2d: R_new lands between R2 and R3,
        with residual gaps on both sides).  Feasibility at this position
        dominates all deeper positions (slack monotonicity, DESIGN.md §2),
        so a single test decides admission.
        """
        blocks = self._blocks
        n = len(blocks)
        pw = self._total_work            # prefix work of blocks[:j], j=n
        for j in range(n, -1, -1):
            left_end = blocks[j - 1].end if j > 0 else cpu_free_time
            right_start = blocks[j].start if j < n else float("inf")
            cap = min(right_start, d)    # get_useful_area (Alg. 3) right edge
            if cap > left_end:           # rightmost non-empty useful area
                if cap - (cpu_free_time + pw) >= p - _EPS:
                    return j, cap
                return None              # infeasible here => infeasible everywhere
            if j > 0:
                pw -= blocks[j - 1].size
        return None

    # -- Algorithms 4+5: shift_or_alloc / alloc_request ----------------------
    def _insert_with_shift(self, j: int, request: Request, window_right: float) -> None:
        p = request.proc_time
        new_start = window_right - p
        # Cascade left-shift (Fig. 2d): each earlier block is pulled left just
        # enough that it no longer overlaps the block to its right.
        required_end = new_start
        for i in range(j - 1, -1, -1):
            b = self._blocks[i]
            if b.end <= required_end + _EPS:
                break
            size = b.size
            b.end = required_end
            b.start = required_end - size
            required_end = b.start
        self._blocks.insert(j, Block(request, new_start, window_right))

    def _compact_all(self, cpu_free_time: float) -> None:
        t = cpu_free_time
        for b in self._blocks:
            size = b.size
            b.start = t
            b.end = t + size
            t = b.end

    # -- executor side -------------------------------------------------------
    def peek(self) -> Optional[Request]:
        return self._blocks[0].request if self._blocks else None

    def pop(self) -> Optional[Request]:
        if not self._blocks:
            return None
        blk = self._blocks.pop(0)
        self._total_work -= blk.size
        return blk.request


class FastPreferentialQueue(PreferentialQueue):
    """Sub-linear feasibility search (beyond-paper optimization).

    Uses the structure derived in DESIGN.md §2: the only position the paper's
    Alg. 2 can allocate at is the *rightmost non-empty useful area* ``j*``:

    * ``j* = e_hi = bisect(ends, d)`` when no admitted block straddles the
      deadline (window right edge = d), else
    * ``j*`` = the rightmost real gap left of the straddler,

    and feasibility at ``j*`` dominates every deeper position, so ONE test
    ``cap - (cpu_free + prefix_work[j*]) >= p`` decides admission.

    The index (``_starts``/``_ends``/``_sizes`` kept in lockstep with the
    block list) is maintained *incrementally* — C-speed ``list.insert`` /
    cascade writes — and the single prefix sum is computed from whichever
    end of the queue is closer, so a push costs
    ``O(log n + min(j*, n - j*) + cascade)`` instead of the faithful O(n)
    walk.  Accepted set and block layout are identical to the faithful queue
    (property-tested in tests/test_block_queue.py;
    tests/test_torch_serving.py holds this copy against the reference's).
    """

    def __init__(self, forced_compaction: bool = False) -> None:
        super().__init__(forced_compaction)
        self._starts: List[float] = []
        self._ends: List[float] = []
        self._sizes: List[float] = []

    # -- index maintenance -----------------------------------------------
    def _prefix_work(self, j: int) -> float:
        sizes = self._sizes
        n = len(sizes)
        if j <= n - j:
            return sum(sizes[:j])
        return self._total_work - sum(sizes[j:])

    def _search_alloc_space(self, p: float, d: float, cpu_free_time: float):
        starts, ends = self._starts, self._ends
        n = len(starts)
        cap_idx = bisect.bisect_left(starts, d)   # first block starting >= d
        e_hi = bisect.bisect_left(ends, d)        # number of blocks ending < d

        if e_hi >= cap_idx:
            j, cap = e_hi, d
        else:
            # a block straddles d; rightmost real gap at/left of it
            j = -1
            for i in range(e_hi, 0, -1):
                if starts[i] > ends[i - 1]:
                    j = i
                    break
            if j < 0:
                cap0 = min(starts[0], d) if n else d
                if cap0 <= cpu_free_time:
                    return None
                j, cap = 0, cap0
            else:
                cap = min(starts[j], d)
        if cap - (cpu_free_time + self._prefix_work(j)) >= p - _EPS:
            return j, cap
        return None

    def _insert_with_shift(self, j: int, request: Request,
                           window_right: float) -> None:
        p = request.proc_time
        new_start = window_right - p
        required_end = new_start
        blocks = self._blocks
        starts, ends = self._starts, self._ends
        for i in range(j - 1, -1, -1):
            b = blocks[i]
            if b.end <= required_end + _EPS:
                break
            size = b.size
            b.end = required_end
            b.start = required_end - size
            ends[i] = b.end
            starts[i] = b.start
            required_end = b.start
        blocks.insert(j, Block(request, new_start, window_right))
        starts.insert(j, new_start)
        ends.insert(j, window_right)
        self._sizes.insert(j, p)

    def _compact_all(self, cpu_free_time: float) -> None:
        super()._compact_all(cpu_free_time)
        self._starts = [b.start for b in self._blocks]
        self._ends = [b.end for b in self._blocks]

    def push(self, request: Request, cpu_free_time: float,
             forced: bool = False) -> bool:
        ok = super().push(request, cpu_free_time, forced)
        if ok and len(self._starts) != len(self._blocks):
            # forced tail append path (base class bypasses _insert_with_shift)
            b = self._blocks[-1]
            self._starts.append(b.start)
            self._ends.append(b.end)
            self._sizes.append(b.size)
        return ok

    def pop(self) -> Optional[Request]:
        req = super().pop()
        if req is not None:
            self._starts.pop(0)
            self._ends.pop(0)
            self._sizes.pop(0)
        return req
