"""Compute ops: modular arithmetic, the radix-2 transform (GPU kernel and
plain XLA reference), four-step, base conversion, gadget digits."""

from . import modmul  # noqa: F401
