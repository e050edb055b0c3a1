"""Link pricing for referrals between MEC nodes, and the radio access
model (cells, uplink pricing, mobility handovers) as a workload axis."""
from repro_torch.netsim.link import (BYTES_PER_PIXEL, PROFILES, LinkModel,
                                     NetParams, default_payload,
                                     paper_campus)
from repro_torch.netsim.radio import CellSite, RadioModel, RadioWorkload

__all__ = ["BYTES_PER_PIXEL", "PROFILES", "LinkModel", "NetParams",
           "default_payload", "paper_campus", "CellSite", "RadioModel",
           "RadioWorkload"]
