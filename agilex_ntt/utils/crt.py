"""Chinese-remainder reconstruction for RNS residue arrays (host-side).

Pure-Python big-int Garner composition; the device side never needs wide
integers (all device arithmetic stays in 30-bit-prime uint32 channels)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def crt_compose(residues: np.ndarray, qs: Sequence[int]) -> np.ndarray:
    """residues: (L, ...) uint arrays; returns (...) object array of ints in
    [0, prod(qs))."""
    L = len(qs)
    if residues.shape[0] != L:
        raise ValueError(f"leading axis {residues.shape[0]} != len(qs) {L}")
    modulus = 1
    for q in qs:
        modulus *= q
    acc = np.zeros(residues.shape[1:], dtype=object)
    for i, q in enumerate(qs):
        mi = modulus // q
        inv = pow(mi % q, -1, q)
        term = (residues[i].astype(object) * (mi * inv)) % modulus
        acc = (acc + term) % modulus
    return acc


def crt_centered(residues: np.ndarray, qs: Sequence[int]) -> np.ndarray:
    """Like crt_compose but mapped to the centered range (-M/2, M/2]."""
    M = 1
    for q in qs:
        M *= q
    vals = crt_compose(residues, qs)
    return np.where(vals > M // 2, vals - M, vals)
