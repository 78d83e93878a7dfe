"""Node-protocol wire format (the port's own copy of sybil_tpu/parallel/
wire.py: the two packages write and read the same results).

The reference ships queries between machines as gob(FlagDefs) and partial
results as gob(NodeResults{QuerySpec,...}) over stdin/stdout
(src/lib/config.go:178-192, printer.go:272-289, node_aggregator.go:8-13).
Here the same protocol rides JSON: Flags.encode()/decode() carries the
query; this module carries the partial results, including full histogram
state so the aggregator can either adopt a hist verbatim (single-node
group) or re-bucket via the full merge (cross-node group,
query_spec.go:118-135).
"""

from __future__ import annotations

import base64

import numpy as np

from ..query.engine import QueryResults
from ..query.hist import BasicHist, MultiHist, TDigestHist
from ..query.hll import HLL
from ..query.spec import QueryParams, Result


def hist_to_wire(h) -> dict:
    if isinstance(h, TDigestHist):
        # centroid form, the analog of the reference's gob AsBytes
        # marshalling (hist_tdigest.go:30-45)
        return {
            "type": "tdigest",
            "info_min": h.info_min, "info_max": h.info_max,
            "hist_bucket": h.hist_bucket,
            "avg": h.avg, "count": h.count, "samples": h.samples,
            "outliers": list(h.outliers),
            "centroids": list(h.td.centroids()),
        }
    return {
        "type": "multi" if isinstance(h, MultiHist) else "basic",
        "info_min": h.info_min, "info_max": h.info_max,
        "hist_bucket": h.hist_bucket,
        "percentile_mode": h.percentile_mode,
        "avg": h.avg, "count": h.count, "samples": h.samples,
        "min": h.min, "max": h.max,
        "values": np.asarray(h.values).tolist(),
        "outliers": list(h.outliers),
        "underliers": list(getattr(h, "underliers", [])),
    }


def hist_from_wire(d: dict):
    if d["type"] == "tdigest":
        h = TDigestHist(d["info_min"], d["info_max"],
                        d.get("hist_bucket", 0))
        h.avg = d["avg"]
        h.count = d["count"]
        h.samples = d["samples"]
        h.outliers = list(d.get("outliers", []))
        means, weights = d["centroids"]
        h.td.add_many(means, weights)
        return h
    cls = MultiHist if d["type"] == "multi" else BasicHist
    h = cls(d["info_min"], d["info_max"], d.get("hist_bucket", 0),
            percentile_mode=d["percentile_mode"])
    vals = np.asarray(d["values"], dtype=np.int64)
    if len(vals) == len(h.values):
        h.values = vals
    elif len(vals):
        h.values = vals  # trust sender's layout
    h.avg = d["avg"]
    h.count = d["count"]
    h.samples = d["samples"]
    h.min = d["min"]
    h.max = d["max"]
    h.outliers = list(d.get("outliers", []))
    if hasattr(h, "underliers"):
        h.underliers = list(d.get("underliers", []))
    return h


def result_to_wire(r: Result) -> dict:
    out = {
        "group_key": r.group_key,
        "count": r.count,
        "samples": r.samples,
        "hists": {k: hist_to_wire(h) for k, h in r.hists.items()},
    }
    if r.distinct is not None:
        out["distinct"] = base64.b64encode(
            r.distinct.registers.tobytes()).decode()
    return out


def result_from_wire(d: dict) -> Result:
    r = Result()
    r.group_key = d["group_key"]
    r.count = d["count"]
    r.samples = d["samples"]
    r.hists = {k: hist_from_wire(h) for k, h in d.get("hists", {}).items()}
    if "distinct" in d:
        hll = HLL()
        hll.registers = np.frombuffer(
            base64.b64decode(d["distinct"]), dtype=np.uint8).copy()
        r.distinct = hll
    return r


def results_to_wire(qr: QueryResults, params: QueryParams) -> dict:
    return {
        "QuerySpec": {
            "results": [result_to_wire(r) for r in qr.results.values()],
            "time_results": {
                str(tb): [result_to_wire(r) for r in rm.values()]
                for tb, rm in qr.time_results.items()},
            "cumulative": (result_to_wire(qr.cumulative)
                           if qr.cumulative else None),
            "matched_count": qr.matched_count,
        },
        "Samples": qr.samples,
    }


def results_from_wire(d: dict) -> QueryResults:
    qr = QueryResults()
    spec = d.get("QuerySpec", {})
    qr.results = {}
    for rw in spec.get("results", []):
        r = result_from_wire(rw)
        qr.results[r.group_key] = r
    for tb, rows in spec.get("time_results", {}).items():
        qr.time_results[int(tb)] = {
            r.group_key: r for r in map(result_from_wire, rows)}
    if spec.get("cumulative"):
        qr.cumulative = result_from_wire(spec["cumulative"])
    qr.matched_count = spec.get("matched_count", 0)
    qr.samples = d.get("Samples", [])
    return qr
