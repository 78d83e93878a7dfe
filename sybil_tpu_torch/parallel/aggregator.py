"""Multi-node result aggregation (the `aggregate` subcommand; the port's
own copy of sybil_tpu/parallel/aggregator.py, device-free).

Port of VTable.StitchResults (src/lib/node_aggregator.go:179): reads
per-node wire results from directories and dispatches on query type —
union of table lists, summed table info, concatenated samples, or the
group-by merge.

Cross-node histogram merge: when two nodes report the same group with
identical bucket layouts the arrays add exactly; otherwise the hist is
re-bucketed over the combined range by re-adding sparse buckets, the
reference's fullMergeHist (query_spec.go:118-135).

Deliberate divergence: the reference forces FLAGS.OP="hist" during
aggregation (node_aggregator.go:169) which makes cross-node merges of
`-op avg` histograms drop their running mean entirely (non-percentile
hists expose no buckets to re-add).  Here avg/count always merge
weighted, so distributed avg queries return the true mean.
"""

from __future__ import annotations

import json
import os

from ..config import Flags
from ..query.engine import QueryResults
from ..query.hist import BasicHist, MultiHist
from ..query.spec import QueryParams, Result
from ..debug import debug
from . import wire


def find_results_in_dirs(dirs: list[str]) -> dict[str, dict]:
    all_specs = {}
    for d in dirs:
        if not os.path.isdir(d):
            debug("couldn't read dir", d)
            continue
        for fn in sorted(os.listdir(d)):
            path = os.path.join(d, fn)
            try:
                with open(path) as f:
                    all_specs[fn] = json.load(f)
            except (OSError, ValueError) as e:
                debug("decode error", path, e)
    return all_specs


def full_merge_hist(h, ph, params: QueryParams, weight_mode: bool):
    """Re-bucket two hists over their combined range (fullMergeHist)."""
    l1, r1 = h.range_()
    l2, r2 = ph.range_()
    cls = MultiHist if isinstance(h, MultiHist) else BasicHist
    nh = cls(min(l1, l2), max(r1, r2), params.hist_bucket,
             percentile_mode=True)
    for src in (h, ph):
        for bucket, count in src.get_sparse_buckets().items():
            nh.add_weighted_value(bucket, count, weight_mode)
    return nh


def merge_results(into: Result, other: Result, params: QueryParams) -> None:
    """Result.Combine with MERGE_TABLE semantics (query_spec.go:138-193)."""
    if other is None or other.count == 0:
        return
    weight_mode = bool(params.weight_col)
    for k, h in other.hists.items():
        ph = into.hists.get(k)
        if ph is None:
            into.hists[k] = h.clone()  # adopt by copy: `other` may be
            # shared with another result map (master vs cumulative)
        elif (h.percentile_mode and ph.percentile_mode
              and len(h.values) == len(ph.values)
              and h.info_min == ph.info_min and h.info_max == ph.info_max):
            ph.combine(h)  # identical extents: exact array add
        elif h.percentile_mode and ph.percentile_mode:
            into.hists[k] = full_merge_hist(h, ph, params, weight_mode)
        else:
            # avg-op hists: weighted mean merge (see module docstring)
            ph.combine(h)
    if other.distinct is not None:
        if into.distinct is None:
            from ..query.hll import HLL
            into.distinct = HLL()
            into.distinct.registers = other.distinct.registers.copy()
        else:
            into.distinct.merge(other.distinct)
    into.samples += other.samples
    into.count += other.count


def aggregate_specs(node_results: dict[str, dict],
                    params: QueryParams) -> QueryResults:
    qr = QueryResults()
    master: dict[str, Result] = {}
    master_time: dict[int, dict[str, Result]] = {}
    cumulative = Result()
    cumulative.group_key = "TOTAL"
    if len(params.groups) > 1:
        cumulative.group_key += "\t" * (len(params.groups) - 1)

    for _, nres in sorted(node_results.items()):
        spec = wire.results_from_wire(nres)
        qr.matched_count += spec.matched_count
        for key, r in spec.results.items():
            if key in master:
                merge_results(master[key], r, params)
            else:
                master[key] = r
            merge_results(cumulative, r, params)
        for tb, rm in spec.time_results.items():
            mtb = master_time.setdefault(tb, {})
            for key, r in rm.items():
                if key in mtb:
                    merge_results(mtb[key], r, params)
                else:
                    mtb[key] = r

    qr.results = master
    qr.time_results = master_time
    qr.cumulative = cumulative

    def sort_key(r: Result):
        if params.order_by == "$COUNT":
            return r.count
        h = r.hists.get(params.order_by)
        return h.mean() if h else 0.0

    qr.sorted = sorted(master.values(), key=sort_key, reverse=True)
    if params.order_asc:
        qr.sorted.reverse()
    return qr


def stitch_results(dirs: list[str], params: QueryParams, flags: Flags):
    """-> renders to stdout, dispatching like StitchResults."""
    from .. import printer
    all_results = find_results_in_dirs(dirs)

    if flags.list_tables:
        tables = sorted({t for res in all_results.values()
                         for t in res.get("Tables", [])})
        printer.print_tables(tables, flags)
        return

    if flags.print_info:
        count = 0
        size = 0
        cols = {"strs": set(), "ints": set(), "sets": set()}
        for res in all_results.values():
            info = res.get("Table", {})
            count += info.get("count", 0)
            size += info.get("storageSize", 0)
            for k in cols:
                cols[k].update(info.get("columns", {}).get(k, []))
        printer.print_table_info(
            {"count": count, "storageSize": size,
             "avgObjSize": size / count if count else 0.0,
             "columns": {k: sorted(v) for k, v in cols.items()}}, flags)
        return

    if flags.samples:
        samples = []
        for res in all_results.values():
            samples.extend(res.get("Samples", []))
        printer.print_samples(samples, params, flags)
        return

    qr = aggregate_specs(all_results, params)
    printer.print_results(qr, params, flags)
