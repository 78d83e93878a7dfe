"""Presentation layer: renders QueryResults exactly like the reference's
printer.go (text tables, JSON shapes, samples, table info, encode-results).

Notable replications:
- group keys display with tabs -> commas, trailing commas trimmed, padded
  then truncated to 20 chars (printer.go:192-195)
- Go's "%.0d" prints the empty string for zero counts (printer.go:197)
- JSON maps marshal with sorted keys, matching Go's json.Marshal
- hist JSON: percentiles/buckets/stddev/avg/sum/samples (printer.go:113-124)
"""

from __future__ import annotations

import json
import sys
import time as time_mod

from .config import Flags
from .constants import GROUP_DELIMITER, SORT_COUNT
from .query.engine import QueryResults
from .query.spec import QueryParams, Result


def _count_str(count: int) -> str:
    return "" if count == 0 else str(count)


def result_to_json(res: Result, params: QueryParams) -> dict:
    """Port of toResultJSON (printer.go:109-152)."""
    out: dict = {}
    for agg in params.aggs:
        if agg.op == "hist":
            inner: dict = {}
            out[agg.col] = inner
            h = res.hists.get(agg.col)
            if h is not None:
                inner["percentiles"] = h.get_percentiles()
                inner["buckets"] = {k: v for k, v in h.get_str_buckets().items()
                                    if v > 0}
                inner["stddev"] = h.get_stddev()
                inner["avg"] = h.mean()
                inner["sum"] = h.mean() * float(h.total_count())
                inner["samples"] = h.total_count()
        elif agg.op == "avg":
            h = res.hists.get(agg.col)
            out[agg.col] = h.mean() if h is not None else None

    group_key = res.group_key.split(GROUP_DELIMITER)
    for i, g in enumerate(params.groups):
        out[g] = group_key[i] if i < len(group_key) else ""

    if params.distincts:
        card = res.distinct.cardinality() if res.distinct else 0
        out["Distinct"] = card
        out["Count"] = card
    else:
        out["Count"] = res.count
        out["Samples"] = res.samples
    return out


def _print_json(data, out):
    json.dump(data, out, sort_keys=True, separators=(",", ":"))
    out.write("\n")


def print_result_text(res: Result, params: QueryParams, flags: Flags, out):
    """Port of printResult (printer.go:187-232)."""
    if res is None:
        return
    group_key = res.group_key.replace(GROUP_DELIMITER, ",").rstrip(",")
    line = f"{group_key:<20}"[:20] + _count_str(res.count)
    if params.weight_col:
        line += f" ({res.samples})"
    if params.distincts:
        card = res.distinct.cardinality() if res.distinct else 0
        line += f" Distinct: {card}"
    print(line, file=out)

    for agg in params.aggs:
        col_name = f"  {agg.col:>5}"
        h = res.hists.get(agg.col)
        if agg.op == "hist":
            if h is None:
                continue
            p = h.get_percentiles()
            if p:
                avg_str = f"{h.mean():.2f}"
                std_str = f"{h.get_stddev():.2f}"
                print(col_name, "|", p[0], p[99], "|", avg_str, "|",
                      p[0], p[25], p[50], p[75], p[99], "|", std_str, file=out)
            else:
                print(col_name, "No Data", file=out)
        elif agg.op == "avg":
            mean = h.mean() if h else 0.0
            print(col_name, f"{mean:.2f}", file=out)


def print_sorted_results(qr: QueryResults, params: QueryParams, flags: Flags,
                         out):
    sorted_rs = qr.sorted[: params.limit]
    if flags.json:
        _print_json([result_to_json(r, params) for r in sorted_rs], out)
        return
    if len(sorted_rs) > 1:
        print_result_text(qr.cumulative, params, flags, out)
    for r in sorted_rs:
        print_result_text(r, params, flags, out)


def print_time_results(qr: QueryResults, params: QueryParams, flags: Flags,
                       out):
    """Port of printTimeResults (printer.go:24-96)."""
    top = {r.group_key for r in qr.sorted[: params.limit]}
    if flags.json:
        marshalled = {}
        for tb, results in qr.time_results.items():
            rows = [result_to_json(r, params) for r in results.values()
                    if r.group_key in top]
            marshalled[str(tb)] = rows
        _print_json(marshalled, out)
        return
    for tb in sorted(qr.time_results):
        time_str = time_mod.strftime("%Y-%m-%d %H:%M:%S",
                                     time_mod.localtime(tb))
        for r in qr.time_results[tb].values():
            if params.distincts:
                card = r.distinct.cardinality() if r.distinct else 0
                print(time_str, "\t", card, "\t", r.group_key, "\t", file=out)
            elif not r.hists:
                print(time_str, "\t", r.count, "\t", r.group_key, "\t",
                      file=out)
            else:
                for aggname, h in r.hists.items():
                    print(time_str, "\t", r.count, "\t", r.group_key, "\t",
                          aggname, "\t", f"{h.mean():.2f}", "\t", file=out)


def print_results(qr: QueryResults, params: QueryParams, flags: Flags,
                  out=None):
    """Port of PrintResults dispatch (printer.go:291-308)."""
    out = out or sys.stdout
    if flags.encode_results:
        encode_results(qr, params, out)
        return
    if not flags.print_:
        return
    if params.time_bucket > 0:
        print_time_results(qr, params, flags, out)
    elif params.order_by:
        print_sorted_results(qr, params, flags, out)
    else:
        if flags.json:
            _print_json([result_to_json(r, params)
                         for r in qr.results.values()], out)
            return
        if len(qr.results) > 1:
            print_result_text(qr.cumulative, params, flags, out)
        for i, r in enumerate(qr.results.values()):
            if i >= params.limit:
                return
            print_result_text(r, params, flags, out)


def print_samples(samples: list[dict], params: QueryParams, flags: Flags,
                  out=None):
    out = out or sys.stdout
    rows = samples[: params.limit]
    if flags.encode_results:
        _print_json({"Samples": rows}, out)
        return
    if flags.json:
        _print_json(rows, out)
        return
    for s in rows:
        print(json.dumps(s, sort_keys=True), file=out)


def print_tables(tables: list[str], flags: Flags, out=None):
    out = out or sys.stdout
    if flags.encode_results:
        _print_json({"Tables": tables}, out)
        return
    if flags.json:
        _print_json(tables, out)
        return
    print(" ".join(tables), "", file=out)


def print_table_info(info: dict, flags: Flags, out=None):
    """Port of PrintTableInfo (printer.go:600-647)."""
    out = out or sys.stdout
    if flags.encode_results:
        _print_json({"Table": info}, out)
        return
    if flags.json:
        _print_json(info, out)
        return
    size = info["storageSize"]
    suffixes = ["B", "KB", "MB", "GB", "TB", "PB"]
    suffix_idx = 0
    small = size
    while small > 1024:
        small //= 1024
        suffix_idx += 1
    print("\nString Columns", file=out)
    for c in info["columns"]["strs"]:
        print(" ", c, file=out)
    print("\nInteger Columns", file=out)
    for c in info["columns"]["ints"]:
        print(" ", c, file=out)
    print("\nSet Columns", file=out)
    for c in info["columns"]["sets"]:
        print(" ", c, file=out)
    print("", file=out)
    print("Stats", file=out)
    print("  count", info["count"], file=out)
    print("  storageSize", small, suffixes[suffix_idx], file=out)
    print("  avgObjSize", f"{info['avgObjSize']:.02f}", "bytes", file=out)


# ---------------------------------------------------------------------------
# node protocol: serialized partial results (replaces gob NodeResults,
# printer.go:284-289 / node_aggregator.go:8-13)
# ---------------------------------------------------------------------------

def encode_results(qr: QueryResults, params: QueryParams, out=None):
    out = out or sys.stdout
    from .parallel.wire import results_to_wire
    _print_json(results_to_wire(qr, params), out)
