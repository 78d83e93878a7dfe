"""Table metadata model: column key-table, types, online column stats.

Mirrors the reference's Table bookkeeping:
- KeyTable (name -> column id) / KeyTypes (id -> INT/STR/SET) with
  type-conflict detection      (src/lib/table.go:134-170)
- IntInfo online stats with Welford M2 and outlier-resistant min/max
  (src/lib/table_column_info.go:75-131) — these feed histogram bucket
  ranges, so the update rule is replicated exactly, including the
  STD_CUTOFF/MIN_CUTOFF gating.
- StrInfo top-K string counts  (table_column_info.go:42-70)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .constants import (INT_VAL, MIN_CUTOFF, NO_VAL, SET_VAL, STD_CUTOFF,
                        STR_VAL, TOP_STRING_COUNT, TYPE_NAMES)
from .debug import warn


@dataclass
class IntInfo:
    min: int = 0
    max: int = 0
    avg: float = 0.0
    m2: float = 0.0
    count: int = 0

    def to_json(self):
        return {"min": int(self.min), "max": int(self.max), "avg": self.avg,
                "m2": self.m2, "count": self.count}

    @classmethod
    def from_json(cls, d):
        return cls(d["min"], d["max"], d["avg"], d["m2"], d["count"])

    def update(self, val: int, skip_outliers: bool = True) -> None:
        """Exact port of update_int_info (table_column_info.go:75-131)."""
        if self.count == 0:
            self.min = self.max = val
            self.avg = float(val)
            self.count = 1
            # fall through: reference runs the body on the first value too

        delta = float(val) - self.avg
        stddev = self.m2 / float(self.count - 1) if self.count != 1 else math.inf
        if not (stddev > 1):  # handles inf? no: inf > 1; handles nan/<=1
            stddev = max(self.avg, 1.0)
        if math.isinf(stddev):
            # count==1: Go computes m2/0 = NaN? (0/0) -> Go: 0/0 = NaN; NaN <= 1 is false.
            # Actually Go float 0.0/0.0 is NaN and `stddev <= 1` is false for NaN,
            # so stddev stays NaN and delta/NaN is NaN -> NaN < STD_CUTOFF false.
            # But count==1 < MIN_CUTOFF so min/max still update. Model with inf.
            stddev = math.inf

        ignored = False
        if self.max < val:
            dstd = abs(delta) / stddev if stddev else math.inf
            if (dstd < STD_CUTOFF and self.count > MIN_CUTOFF) or not skip_outliers:
                self.max = val
            else:
                ignored = True
        if self.min > val:
            dstd = abs(delta) / stddev if stddev else math.inf
            if (dstd < STD_CUTOFF and self.count > MIN_CUTOFF) or not skip_outliers:
                self.min = val
            else:
                ignored = True

        if not ignored or self.count < MIN_CUTOFF:
            self.avg = self.avg + delta / float(self.count)
            self.m2 = self.m2 + delta * (float(val) - self.avg)
        self.count += 1

    def update_many(self, vals: np.ndarray, skip_outliers: bool = True) -> None:
        """Sequential update over a value array.

        Fast path: when no value could trip the outlier gate (all within
        STD_CUTOFF sigmas is guaranteed if extending values never get
        ignored), the min/max are exact and avg/m2 follow from a single
        vectorized pass merged via Chan's parallel update.  We detect
        eligibility conservatively; otherwise fall back to the exact loop.
        """
        vals = np.asarray(vals, dtype=np.int64)
        if vals.size == 0:
            return
        # Cold-start values (stored count <= MIN_CUTOFF+1) go through the
        # exact scalar loop: the reference's min/max refuse to move until
        # Count > MIN_CUTOFF and position-4 values that extend min/max are
        # excluded from avg/m2, quirks a vectorized pass can't reproduce.
        # (Stored Count is always true_n + 1: the first update initializes
        # Count=1 and still increments.)
        k = 0
        while self.count <= MIN_CUTOFF + 1 and k < vals.size:
            self.update(int(vals[k]), skip_outliers)
            k += 1
        rest = vals[k:]
        if rest.size == 0:
            return
        if skip_outliers and _needs_exact(rest, self):
            for v in rest.tolist():
                self.update(v, skip_outliers)
            return
        # Warm path: every element sees Count > MIN_CUTOFF and (checked
        # above) can't trip the sigma gate, so the sequential Welford is
        # equivalent to one vectorized pass merged via Chan's formula.
        n = int(rest.size)
        n_a = self.count - 1  # true prior n
        b_avg = float(rest.mean())
        b_m2 = float(((rest - b_avg) ** 2).sum())
        delta = b_avg - self.avg
        tot = n_a + n
        self.m2 = self.m2 + b_m2 + delta * delta * n_a * n / tot
        self.avg = self.avg + delta * n / tot
        self.min = min(self.min, int(rest.min()))
        self.max = max(self.max, int(rest.max()))
        self.count = tot + 1


def _go_band(avg: float, m2: float, count: int) -> float:
    """The reference's gating denominator: variance m2/(count-1), clamped
    to max(avg, 1) when <= 1 (table_column_info.go:86-90)."""
    var = m2 / float(count - 1) if count > 1 else 0.0
    if not var > 1:
        var = max(avg, 1.0)
    return var


def _needs_exact(vals: np.ndarray, info: IntInfo) -> bool:
    """Conservative check whether the outlier-rejection path could fire
    anywhere in the batch: if every value's delta-from-mean stays far
    inside STD_CUTOFF times the smallest plausible gating denominator,
    no value is ever ignored and vectorized merging is exact."""
    v = vals.astype(np.float64)
    n_a = max(info.count - 1, 0)
    mean_end = (info.avg * n_a + v.sum()) / (n_a + v.size)
    b_m2 = float(((v - v.mean()) ** 2).sum())
    band = min(_go_band(info.avg, info.m2, info.count),
               _go_band(mean_end, info.m2 + b_m2, n_a + v.size))
    spread = max(abs(float(v.max()) - min(info.avg, mean_end)),
                 abs(float(v.min()) - max(info.avg, mean_end)),
                 abs(info.max - mean_end), abs(info.min - mean_end))
    # STD_CUTOFF is 1000; stay far inside it
    return spread / band >= STD_CUTOFF / 4


@dataclass
class StrInfo:
    top_string_count: dict[str, int] = field(default_factory=dict)
    cardinality: int = 0

    def to_json(self):
        return {"top": self.top_string_count, "cardinality": self.cardinality}

    @classmethod
    def from_json(cls, d):
        return cls(dict(d.get("top", {})), d.get("cardinality", 0))

    def update_many(self, strs: list[str] | np.ndarray, counts=None) -> None:
        if counts is None:
            uniq, cnt = np.unique(np.asarray(strs, dtype=object), return_counts=True)
        else:
            uniq, cnt = strs, counts
        for s, c in zip(uniq, cnt):
            self.top_string_count[str(s)] = self.top_string_count.get(str(s), 0) + int(c)
        self.prune()

    def prune(self):
        self.cardinality = len(self.top_string_count)
        if self.cardinality > TOP_STRING_COUNT:
            items = sorted(self.top_string_count.items(), key=lambda kv: kv[1])
            for k, _ in items[: self.cardinality - TOP_STRING_COUNT - 1]:
                del self.top_string_count[k]


class Schema:
    """KeyTable + KeyTypes + per-column table-level stats."""

    def __init__(self):
        self.key_table: dict[str, int] = {}
        self.key_types: dict[int, int] = {}
        self.int_info: dict[int, IntInfo] = {}
        self.str_info: dict[int, StrInfo] = {}

    # --- key management (table.go:134-170) ---
    def get_key_id(self, name: str) -> int:
        if name in self.key_table:
            return self.key_table[name]
        kid = len(self.key_table)
        self.key_table[name] = kid
        self.key_types[kid] = NO_VAL
        return kid

    def set_key_type(self, kid: int, ktype: int) -> bool:
        cur = self.key_types.get(kid, NO_VAL)
        if cur == NO_VAL:
            self.key_types[kid] = ktype
            return True
        if cur != ktype:
            name = self.key_name(kid)
            warn("type conflict for column", name, ":",
                 TYPE_NAMES[cur], "vs", TYPE_NAMES[ktype])
            return False
        return True

    def key_name(self, kid: int) -> str:
        for name, i in self.key_table.items():
            if i == kid:
                return name
        return f"<{kid}>"

    def col_type(self, name: str) -> int:
        kid = self.key_table.get(name)
        if kid is None:
            return NO_VAL
        return self.key_types.get(kid, NO_VAL)

    def cols_of_type(self, ktype: int) -> list[str]:
        return sorted(n for n, kid in self.key_table.items()
                      if self.key_types.get(kid) == ktype)

    # --- persistence ---
    def to_json(self):
        return {
            "key_table": self.key_table,
            "key_types": {str(k): v for k, v in self.key_types.items()},
            "int_info": {str(k): v.to_json() for k, v in self.int_info.items()},
            "str_info": {str(k): v.to_json() for k, v in self.str_info.items()},
        }

    @classmethod
    def from_json(cls, d):
        s = cls()
        s.key_table = {k: int(v) for k, v in d.get("key_table", {}).items()}
        s.key_types = {int(k): int(v) for k, v in d.get("key_types", {}).items()}
        s.int_info = {int(k): IntInfo.from_json(v)
                      for k, v in d.get("int_info", {}).items()}
        s.str_info = {int(k): StrInfo.from_json(v)
                      for k, v in d.get("str_info", {}).items()}
        return s
