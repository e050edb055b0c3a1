"""KV-cache session pool for LM decode serving (the port of
``repro/serving/kv_cache.py``; host Python).

A fixed-capacity batched cache (the transformer's (L, B, S, KV, hd) layout)
is treated as B *slots*; sessions are assigned slots from a free list and
evicted on completion or deadline expiry.  This is the slot-allocation
layer; the cache tensors themselves live in
:mod:`repro_torch.models.transformer`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Session:
    session_id: int
    slot: int
    length: int = 0
    deadline: float = float("inf")


class KVCachePool:
    def __init__(self, n_slots: int, max_len: int):
        self.n_slots = n_slots
        self.max_len = max_len
        self._free: List[int] = list(range(n_slots))
        self._sessions: Dict[int, Session] = {}
        self._next_id = 0

    def allocate(self, deadline: float = float("inf")) -> Optional[Session]:
        if not self._free:
            return None
        slot = self._free.pop()
        s = Session(self._next_id, slot, deadline=deadline)
        self._next_id += 1
        self._sessions[s.session_id] = s
        return s

    def release(self, session_id: int) -> None:
        s = self._sessions.pop(session_id, None)
        if s is not None:
            self._free.append(s.slot)

    def advance(self, session_id: int, n: int = 1) -> int:
        s = self._sessions[session_id]
        s.length += n
        if s.length > self.max_len:
            raise ValueError(f"session {session_id} exceeded max_len")
        return s.length

    def evict_expired(self, now: float) -> List[int]:
        dead = [sid for sid, s in self._sessions.items() if now > s.deadline]
        for sid in dead:
            self.release(sid)
        return dead

    @property
    def active(self) -> int:
        return len(self._sessions)

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.n_slots
