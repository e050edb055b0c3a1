"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(:mod:`.ref`) and the device dispatch (:mod:`.ops`).  Kernels are built
from ``csrc/`` at first use (:mod:`.build`), never at import."""
