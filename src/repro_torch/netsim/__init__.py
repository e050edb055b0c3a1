"""Link pricing for referrals between MEC nodes."""
from repro_torch.netsim.link import (BYTES_PER_PIXEL, PROFILES, LinkModel,
                                     NetParams, default_payload,
                                     paper_campus)

__all__ = ["BYTES_PER_PIXEL", "PROFILES", "LinkModel", "NetParams",
           "default_payload", "paper_campus"]
