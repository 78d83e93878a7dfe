"""HyperLogLog count-distinct sketch.

The reference uses github.com/logv/loglogbeta (query_spec.go:8): 2^14
registers, LogLog-Beta bias correction, metro-hashed inputs.  This is the
same construction with the same register count and beta polynomial; the
input hash differs (FNV-1a/splitmix finalizer instead of metrohash), so
estimates agree in distribution but not bit-for-bit — count-distinct is
an approximation in the reference too.

Inputs are byte strings built exactly like the reference's fast/slow
paths (aggregate.go:206-243): int distinct cols pack 8-byte little-endian
values (MaxUint64 for missing); string cols join display strings with a
trailing tab each.
"""

from __future__ import annotations

import math

import numpy as np

P = 14
M = 1 << P


def _beta(ez: float) -> float:
    """LogLog-Beta polynomial for p=14 (loglogbeta's beta14)."""
    zl = math.log(ez + 1)
    return (-0.370393911 * ez
            + 0.070471823 * zl
            + 0.17393686 * zl**2
            + 0.16339839 * zl**3
            + -0.09237745 * zl**4
            + 0.03738027 * zl**5
            + -0.005384159 * zl**6
            + 0.00042419 * zl**7)


_ALPHA = 0.7213 / (1 + 1.079 / M)


def hash64(data: bytes) -> int:
    """FNV-1a 64 with a splitmix64 finalizer (stable, not metrohash)."""
    h = 0xcbf29ce484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    # splitmix64 finalizer for avalanche
    h = (h + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


class HLL:
    __slots__ = ("registers",)

    def __init__(self):
        self.registers = np.zeros(M, dtype=np.uint8)

    def add(self, data: bytes) -> None:
        h = hash64(data)
        idx = h >> (64 - P)
        rest = (h << P) & 0xFFFFFFFFFFFFFFFF
        # leading zeros of the remaining bits, +1
        rank = (64 - rest.bit_length() + 1) if rest else (64 - P + 1)
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    def add_hashes(self, hashes: np.ndarray) -> None:
        """Vectorized register update from precomputed uint64 hashes."""
        hashes = hashes.astype(np.uint64)
        idx = (hashes >> np.uint64(64 - P)).astype(np.int64)
        rest = hashes << np.uint64(P)
        # rank = leading zeros + 1 over remaining bits
        bl = np.zeros(len(hashes), dtype=np.int64)
        x = rest.copy()
        for shift in (32, 16, 8, 4, 2, 1):
            gt = x >= (np.uint64(1) << np.uint64(shift))
            bl = np.where(gt, bl + shift, bl)
            x = np.where(gt, x >> np.uint64(shift), x)
        bl = np.where(rest > 0, bl + 1, 0)  # bit length
        rank = np.where(rest > 0, 64 - bl + 1, 64 - P + 1).astype(np.uint8)
        np.maximum.at(self.registers, idx, rank)

    def merge(self, other: "HLL") -> None:
        np.maximum(self.registers, other.registers, out=self.registers)

    def cardinality(self) -> int:
        ez = float(np.count_nonzero(self.registers == 0))
        total = float(np.sum(np.power(2.0, -self.registers.astype(np.float64))))
        est = _ALPHA * M * (M - ez) / (_beta(ez) + total)
        return int(est + 0.5)
