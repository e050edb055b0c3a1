"""Deadline-aware serving of vision inference over model replicas, and
the KV-cache session pool of LM decode serving."""
from repro_torch.serving.engine import (DeadlineAwareEngine, ServeRequest,
                                        ServiceClass, ServingReplica,
                                        measure_step_times)
from repro_torch.serving.kv_cache import KVCachePool, Session

__all__ = ["DeadlineAwareEngine", "KVCachePool", "ServeRequest",
           "ServiceClass", "ServingReplica", "Session", "measure_step_times"]
