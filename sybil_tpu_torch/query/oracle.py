"""Row-at-a-time oracle engine, used by the test suite as the behavioral
golden reference.

This is a faithful Python transcription of FilterAndAggRecords
(src/lib/aggregate.go:56-282) operating on host-decoded columns: per
record it applies filters, builds the group key, applies the weight
column, does time bucketing, updates hists via the exact
add_weighted_value port, and feeds distinct values into the HLL.  The
device engine (engine.py) must agree with this on every query shape.

Binding is INDEPENDENT of the engine's BoundQuery: the oracle resolves
column types, filter literals, regex bitsets, histogram layouts, and
block pruning itself, so a bind-time bug in the engine cannot cancel out
in engine-vs-oracle comparisons.

Deliberately slow; never used on the production path.
"""

from __future__ import annotations

import re

from .. import blocks as blockio
from ..config import Flags
from ..constants import GROUP_DELIMITER, INT_VAL, STR_VAL
from ..debug import error
from ..table import Table
from .hist import BasicHist, MultiHist
from .hll import HLL
from .spec import QueryParams, Result

MISSING_I64 = -1
SORT_COUNT = "$COUNT"


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


class _OracleBinding:
    """Self-contained resolution of a QueryParams against a table —
    deliberately sharing no code with engine.BoundQuery."""

    def __init__(self, table: Table, params: QueryParams, flags: Flags):
        self.table = table
        self.params = params
        self.flags = flags
        schema = table.schema
        self._strings_cache: dict[str, list[str]] = {}

        self.col_types: dict[str, int] = {}
        cols = set(params.groups) | set(params.distincts)
        cols |= {a.col for a in params.aggs}
        cols |= {f.col for f in params.filters}
        if params.time_bucket > 0:
            cols.add(params.time_col)
        if params.weight_col:
            cols.add(params.weight_col)
        for c in sorted(cols):
            t = schema.col_type(c)
            if t == 0:  # NO_VAL
                error("oracle: unknown column", c)
            self.col_types[c] = t
        self.needed_cols = sorted(cols)

        # filters: literal and regex resolution
        self.filters = []
        for f in params.filters:
            if f.kind == "int":
                self.filters.append((f, int(f.value), None))
            elif f.op in ("re", "nre"):
                rx = re.compile(f.value)
                strings = self.strings(f.col)
                bits = [rx.search(s) is not None for s in strings]
                self.filters.append((f, 0, bits))
            else:
                # resolve eq/neq/in/nin literal against the dictionary
                strings = self.strings(f.col)
                try:
                    gid = strings.index(f.value)
                except ValueError:
                    gid = -1
                self.filters.append((f, gid, None))

        # aggregation layouts straight from table-level IntInfo
        self.agg_layouts = []
        for a in params.aggs:
            kid = schema.key_table[a.col]
            info = schema.int_info.get(kid)
            if info is None:
                error("oracle: no int info for agg column", a.col)
            self.agg_layouts.append((info, a.op == "hist", a.hist_type))

    def strings(self, col: str) -> list[str]:
        got = self._strings_cache.get(col)
        if got is not None:
            return got
        strings = list(self.table.dicts.get(col).strings)
        rep = self.params.str_replace.get(col)
        if rep:
            rx = re.compile(rep[0])
            strings = [rx.sub(rep[1], s) for s in strings]
        self._strings_cache[col] = strings
        return strings

    def should_scan_block(self, info) -> bool:
        """Independent min/max pruning (table_block_io.go:110-182)."""
        if not info.int_info:
            return True
        kt = self.table.schema.key_table
        for f in self.params.filters:
            if f.kind != "int" or f.op not in ("gt", "lt", "eq"):
                continue
            ii = info.int_info.get(kt.get(f.col))
            if ii is None:
                return False
            v = int(f.value)
            if f.op == "gt" and ii.max <= v:
                return False
            if f.op == "lt" and ii.min >= v:
                return False
            if f.op == "eq" and (ii.min > v or ii.max < v):
                return False
        return True


def run_oracle(table: Table, params: QueryParams,
               flags: Flags | None = None):
    from .engine import QueryResults  # result container only

    flags = flags or table.flags
    table.load_info()
    bound = _OracleBinding(table, params, flags)
    schema = table.schema

    weight_mode = bool(params.weight_col)
    time_mode = params.time_bucket > 0

    rows: dict[tuple, Result] = {}
    time_rows: dict[int, dict[tuple, Result]] = {}
    totals: dict[tuple, Result] = {}
    matched_count = 0

    for bdir in table.list_block_dirs():
        info = blockio.load_block_info(bdir)
        if info is None or not bound.should_scan_block(info):
            continue
        data = blockio.load_block_columns(bdir, schema, bound.needed_cols)
        n = info.num_records

        for r in range(n):
            ok = True
            for f, fv, bits in bound.filters:
                if not _apply_filter(data.get(f.col), r, f, fv, bits):
                    ok = False
                    break
            if not ok:
                continue
            matched_count += 1

            weight = 1
            if params.weight_col:
                wc = data.get(params.weight_col)
                if wc is not None and wc.valid[r]:
                    weight = int(wc.values[r])

            key = []
            for g in params.groups:
                cd = data.get(g)
                if cd is None or not cd.valid[r]:
                    key.append(MISSING_I64)
                elif isinstance(cd, blockio.IntColumnData):
                    key.append(int(cd.values[r]))
                else:
                    key.append(int(cd.ids[r]))
            key = tuple(key)

            result_map = rows
            if time_mode:
                tc = data.get(params.time_col)
                if tc is None or not tc.valid[r]:
                    continue
                tval = _trunc_div(int(tc.values[r]),
                                  params.time_bucket) * params.time_bucket
                tot = totals.get(key)
                if tot is None:
                    tot = _new_result(key, bound)
                    totals[key] = tot
                tot.samples += 1
                tot.count += weight
                result_map = time_rows.setdefault(tval, {})

            res = result_map.get(key)
            if res is None:
                res = _new_result(key, bound)
                result_map[key] = res
            res.samples += 1
            res.count += weight

            if params.distincts:
                if res.distinct is None:
                    res.distinct = HLL()
                res.distinct.add(_distinct_bytes(params, bound, data, r))

            for adef, (ainfo, want_hist, hist_type) in zip(
                    params.aggs, bound.agg_layouts):
                cd = data.get(adef.col)
                if cd is None or not cd.valid[r]:
                    continue
                h = res.hists.get(adef.col)
                if h is None:
                    if want_hist and hist_type == "tdigest":
                        from .hist import TDigestHist
                        cls = TDigestHist
                    elif want_hist and hist_type == "multi":
                        cls = MultiHist
                    else:
                        cls = BasicHist
                    h = cls(ainfo.min, ainfo.max, params.hist_bucket,
                            percentile_mode=want_hist)
                    res.hists[adef.col] = h
                h.add_weighted_value(int(cd.values[r]), weight, weight_mode)

    qr = QueryResults()
    qr.matched_count = matched_count
    qr.results = {r.group_key: r for r in
                  (totals if time_mode else rows).values()}
    for tb, m in time_rows.items():
        qr.time_results[tb] = {r.group_key: r for r in m.values()}

    cumulative = Result()
    cumulative.group_key = "TOTAL"
    if len(params.groups) > 1:
        cumulative.group_key += GROUP_DELIMITER * (len(params.groups) - 1)
    for res in qr.results.values():
        cumulative.combine(res)
    qr.cumulative = cumulative

    _sort(qr, params)
    return qr


def _sort(qr, params: QueryParams) -> None:
    """Independent SortResults port (aggregate.go:497-525)."""
    if not params.order_by:
        return

    def sort_key(r: Result):
        if params.order_by == SORT_COUNT:
            return r.count
        h = r.hists.get(params.order_by)
        return h.mean() if h else 0.0

    qr.sorted = sorted(qr.results.values(), key=sort_key, reverse=True)
    if params.order_asc:
        qr.sorted.reverse()


def _new_result(key, bound: _OracleBinding) -> Result:
    res = Result()
    res.key_tuple = key
    params = bound.params
    parts = []
    if not params.groups:
        parts.append("total")
    else:
        for col, v in zip(params.groups, key):
            if v == MISSING_I64:
                parts.append("")
            elif bound.col_types[col] == STR_VAL:
                strings = bound.strings(col)
                parts.append(strings[v] if 0 <= v < len(strings) else "")
            else:
                parts.append(str(v))
            parts.append(GROUP_DELIMITER)
    res.group_key = "".join(parts)
    return res


def _apply_filter(cd, r, f, fv, bits) -> bool:
    if f.kind == "set":
        if not isinstance(cd, blockio.SetColumnData):
            return False
        lo, hi = int(cd.offsets[r]), int(cd.offsets[r + 1])
        if hi == lo:
            return False
        present = fv in cd.values[lo:hi]
        return present if f.op == "in" else not present
    if cd is None or not cd.valid[r]:
        return False
    v = int(cd.values[r]) if isinstance(cd, blockio.IntColumnData) \
        else int(cd.ids[r])
    if f.op == "gt":
        return v > fv
    if f.op == "lt":
        return v < fv
    if f.op == "eq":
        return v == fv
    if f.op == "neq":
        return v != fv
    if f.op in ("re", "nre"):
        hit = bool(bits[v]) if 0 <= v < len(bits) else False
        return hit if f.op == "re" else not hit
    return False


def _distinct_bytes(params, bound: _OracleBinding, data, r) -> bytes:
    int_only = all(bound.col_types[d] == INT_VAL for d in params.distincts)
    if int_only:
        out = b""
        for d in params.distincts:
            cd = data.get(d)
            if cd is None or not cd.valid[r]:
                v = (1 << 64) - 1
            else:
                v = int(cd.values[r]) & ((1 << 64) - 1)
            out += v.to_bytes(8, "little")
        return out
    parts = []
    for d in params.distincts:
        cd = data.get(d)
        if cd is None or not cd.valid[r]:
            parts.append("")
        elif bound.col_types[d] == STR_VAL:
            parts.append(bound.strings(d)[int(cd.ids[r])])
        else:
            parts.append(str(int(cd.values[r])))
    return (GROUP_DELIMITER.join(parts) + GROUP_DELIMITER).encode()
