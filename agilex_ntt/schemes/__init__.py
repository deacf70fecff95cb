"""Scheme layer: production FHE evaluators built on the ring/RNS stack.

The reference stops at the forward transform (`/root/reference/src/kernel/
ntt.cpp` is the NTT an FHE accelerator feeds); this package supplies the
scheme on top — the workload the NTT exists to serve — so the framework is
usable end to end on the device.
"""

from .bfv import BFVContext
from .bgv import BGVContext
from .ckks import (
    CKKSContext,
    Ciphertext,
    KeySet,
    LinearOp,
    MatVecOp,
    Plaintext,
)

__all__ = ["BFVContext", "BGVContext", "CKKSContext", "Ciphertext",
           "KeySet", "LinearOp", "MatVecOp", "Plaintext"]
