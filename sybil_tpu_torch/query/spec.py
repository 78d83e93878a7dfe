"""Query specification and result model.

Mirrors the reference's QuerySpec/QueryParams/Result
(src/lib/query_spec.go:25-105) with JSON (not gob) as the serialized
form; the md5-of-params cache key (query_spec.go:249-260) is preserved.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from ..config import Flags
from ..constants import GROUP_DELIMITER, SORT_COUNT


@dataclass(frozen=True)
class FilterDef:
    col: str
    op: str           # int: gt/lt/eq/neq ; str: eq/neq/re/nre ; set: in/nin
    value: str        # raw token; typed at bind time
    kind: str         # "int" | "str" | "set"


@dataclass(frozen=True)
class AggDef:
    col: str
    op: str           # "avg" | "hist" | ""
    hist_type: str = "basic"   # "basic" | "multi" | "tdigest"


@dataclass
class QueryParams:
    filters: tuple[FilterDef, ...] = ()
    groups: tuple[str, ...] = ()
    aggs: tuple[AggDef, ...] = ()
    distincts: tuple[str, ...] = ()
    order_by: str = SORT_COUNT
    order_asc: bool = False
    prune_by: str = SORT_COUNT
    limit: int = 100
    num_distinct: int = -1
    time_bucket: int = 0       # 0 = no time rollup
    time_col: str = "time"
    weight_col: str = ""
    hist_bucket: int = 0       # -int-bucket override
    samples: bool = False
    sample_cols: tuple[str, ...] = ()   # -sample-cols restriction
    str_replace: dict = field(default_factory=dict)

    def cache_key(self) -> str:
        payload = json.dumps({
            "filters": [vars(f) for f in self.filters],
            "groups": self.groups, "aggs": [vars(a) for a in self.aggs],
            "distincts": self.distincts, "order_by": self.order_by,
            "order_asc": self.order_asc, "prune_by": self.prune_by,
            "limit": self.limit, "num_distinct": self.num_distinct,
            "time_bucket": self.time_bucket, "time_col": self.time_col,
            "weight_col": self.weight_col, "hist_bucket": self.hist_bucket,
            "sample_cols": self.sample_cols,
            "str_replace": self.str_replace,
        }, sort_keys=True, default=list)
        return hashlib.md5(payload.encode()).hexdigest()

    @classmethod
    def from_flags(cls, flags: Flags) -> "QueryParams":
        filters = []
        for raw, kind in ((flags.int_filters, "int"), (flags.str_filters, "str"),
                          (flags.set_filters, "set")):
            for tok in flags.split_list(raw):
                parts = tok.split(flags.filter_separator)
                if len(parts) < 3:
                    continue
                col, op, value = parts[0], parts[1], parts[2]
                # time filters align to the bucket in time mode (filter.go:86-95)
                if (kind == "int" and flags.time and col == flags.time_col):
                    bucket = flags.time_bucket
                    v = int(value)
                    value = str(_trunc_div(v, bucket) * bucket)
                filters.append(FilterDef(col, op, value, kind))

        op = flags.op
        groups = tuple(flags.split_list(flags.groups))
        distincts = tuple(flags.split_list(flags.distinct))
        if op == "distinct":
            # -op distinct promotes group cols to distinct cols (cmd_query.go:221-224)
            distincts = groups
            groups = ()

        hist_type = ("tdigest" if flags.tdigest
                     else "multi" if flags.log_hist else "basic")
        aggs = tuple(AggDef(c, op if op in ("avg", "hist") else "avg", hist_type)
                     for c in flags.split_list(flags.ints))

        replace = {}
        for tok in flags.split_list(flags.str_replace):
            parts = tok.split(flags.filter_separator)
            if len(parts) == 3:
                replace[parts[0]] = (parts[1], parts[2])

        return cls(
            filters=tuple(filters), groups=groups, aggs=aggs,
            distincts=distincts, order_by=flags.sort, order_asc=flags.sort_asc,
            prune_by=flags.prune_by, limit=flags.limit,
            num_distinct=flags.num_distinct,
            time_bucket=flags.time_bucket if flags.time else 0,
            time_col=flags.time_col, weight_col=flags.weight_col,
            hist_bucket=flags.hist_bucket, samples=flags.samples,
            sample_cols=tuple(flags.split_list(flags.sample_cols)),
            str_replace=replace,
        )


def _trunc_div(a: int, b: int) -> int:
    """Go integer division truncates toward zero; Python floors."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


class Result:
    """One group-by row (query_spec.go:85-93)."""

    __slots__ = ("count", "samples", "hists", "distinct", "group_key", "key_tuple")

    def __init__(self):
        self.count = 0
        self.samples = 0
        self.hists = {}            # agg name -> hist object
        self.distinct = None       # HLL
        self.group_key = ""        # display string, "\t"-joined
        self.key_tuple = ()        # raw int64 key values

    def combine(self, other: "Result") -> None:
        # reference short-circuits on zero-count partials (query_spec.go:139-145)
        if other is None or other.count == 0:
            return
        for k, h in other.hists.items():
            if k in self.hists:
                self.hists[k].combine(h)
            else:
                self.hists[k] = h.clone()
        if other.distinct is not None:
            if self.distinct is None:
                from .hll import HLL
                self.distinct = HLL()
                self.distinct.registers = other.distinct.registers.copy()
            else:
                self.distinct.merge(other.distinct)
        self.samples += other.samples
        self.count += other.count
