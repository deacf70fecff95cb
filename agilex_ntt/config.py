"""Configuration core for the NTT framework.

This replaces the reference's compile-time preprocessor configuration system
(component C11 in SURVEY.md: ``FPGA_NTT_SIZE`` / ``VEC`` / ``NUM_NTT_COMPUTE_UNITS``
/ ``REORDER`` macros, ``/root/reference/src/kernel/ntt.cpp:8-24`` and
``include/kernel/ntt.h:7-23``) with a single runtime dataclass that drives trace-time shapes.  Unlike the reference there is
exactly *one* source of truth (the reference duplicates the size table in
``ntt.h:11-23`` and ``ntt.cpp:70-80`` and re-defines ``FPGA_NTT_SIZE`` in
``main.cpp:9``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Transform sizes the reference supports at compile time (ntt.h:11-23).
# We support any power of two in [32, 2**17]; this tuple mirrors the
# reference's menu for parity tests and presets.
REFERENCE_SIZES: Tuple[int, ...] = (32, 1024, 8192, 16384, 32768)


def is_power_of_two(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def log2_exact(x: int) -> int:
    if not is_power_of_two(x):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class NTTConfig:
    """Static configuration for one negacyclic NTT ring Z_q[X]/(X^n + 1).

    Attributes:
      n: transform size (power of two). The reference supports
         {32, 1024, 8192, 16384, 32768} at compile time; we accept any
         power of two >= 8.
      q: the NTT-friendly prime modulus, q ≡ 1 (mod 2n). Must be < 2**30 so
         that the lazy Harvey butterfly invariant (values in [0, 4q)) fits in
         uint32 words — the 32-bit analog of the reference's
         HEXL_FPGA_USE_64BIT_MULT 32-bit-limb synthesis (ntt.cpp:32, 346-363).
    """

    n: int
    q: int

    def __post_init__(self):
        if not is_power_of_two(self.n) or self.n < 8:
            raise ValueError(f"n must be a power of two >= 8, got {self.n}")
        if self.q >= (1 << 30):
            raise ValueError(
                f"q must be < 2**30 for uint32 lazy arithmetic, got {self.q}"
            )
        if self.q % (2 * self.n) != 1:
            raise ValueError(
                f"q must satisfy q ≡ 1 (mod 2n): q={self.q}, n={self.n}"
            )

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)
