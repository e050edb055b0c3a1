"""Deadline-aware serving of vision inference over model replicas."""
from repro_torch.serving.engine import (DeadlineAwareEngine, ServeRequest,
                                        ServiceClass, ServingReplica,
                                        measure_step_times)

__all__ = ["DeadlineAwareEngine", "ServeRequest", "ServiceClass",
           "ServingReplica", "measure_step_times"]
