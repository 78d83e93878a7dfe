#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sybil_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Phases (any failure exits non-zero before the result lines):
  1. print the card's name and power limit (nvidia-smi); build the CUDA
     kernels from sybil_tpu_torch/csrc, one nvcc per source, in parallel
  2. build an uptime table of N rows (default 8,388,608 = 128 full
     blocks) with the port's Table.ingest_columns and bench.py's
     generator and seed, and a user_sessions table of N rows with
     scripts/fakedata/activity_generator.columns (its seed rule, 1M-row
     steps, as scripts/bench_configs.py builds it)
  3. K1 decode_bucket2 against its plain PyTorch version on the card,
     bit for bit: the table's real host and ping containers, then edge
     blocks (u8/u16/i32 deltas, short, missing, invalid rows)
  4. K2 dense_scan, K4 dense_hist, K5 outlier_compact and K3 dense_pack
     against their plain versions, word for word: on the decoded uptime
     batch (group by host avg ping, a weight column, three keys whose sum
     table exceeds shared memory, a value-biased int32-packed config,
     partial blocks, a spilling key bound; config 3 `status eq 200, group
     by host, hist ping` and its -loghist form), on the decoded
     user_sessions batch (config 2), then synthetic edge batches (MISSING
     and negative keys, invalid and out-of-bound values, zero and invalid
     weights, no groups, near 8192 slots, non-compact tables; every
     filter op, weighted hists, multihist sub-outliers, more outliers
     than the packed section holds, a hist table in global memory)
  5. the main path through the port's CLI on cuda, one batch of all
     blocks, the launch counts reset just before each query and read just
     after: config 1 `-group host -int ping -op avg`, config 3 (and with
     -loghist) and config 2; every group's count, sum and bucket counts
     against a numpy group-by of the generated arrays.  Then cold and
     warm queries through run_query for each config, checking via the
     counts that warm queries run no decode (residency) and the scan
     kernels once per batch, also through a three-batch pipeline
  6. timings: query walls (median of 5) and rows/s, and the engine's
     phase breakdown of one cold and one warm query, per config; each
     kernel's time from CUDA events beside its bound (the larger of
     bytes / 3.35 TB/s and integer operations / the INT32 rate), its
     plain version's time and, where one torch call computes the same
     function, that call's time

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 1 first.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# H100 SXM INT32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
BENCH_SEED = 1337               # bench.py:59 (fresh table)
BENCH_NOW = 1_755_000_000
STEP = 1_000_000
KERNELS = ("decode_bucket2", "dense_scan", "dense_hist", "outlier_compact",
           "dense_pack")
FILL = 0x5A5A5A5A5A5A5A5A        # poison for buffers a kernel must write


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 2: the tables
# ---------------------------------------------------------------------------

def build_table(root: str, n_rows: int):
    """bench.py build_dataset's generator and seed, written by the port.
    Returns (Table, Flags, {"host", "status", "ping": per-row arrays},
    host and status as list indices)."""
    import numpy as np

    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table

    flags = Flags(dir=root, table="uptime", skip_compact=True,
                  device_batch=1024)
    t = Table("uptime", flags)
    rng = np.random.default_rng(BENCH_SEED)
    hosts, stats, pings = [], [], []
    for start in range(0, n_rows, STEP):
        n = min(STEP, n_rows - start)
        hosts_idx = rng.integers(0, 5, n)
        stat_idx = rng.integers(0, 5, n)
        ping = np.abs(rng.normal(60, 20, n)).astype(np.int64)
        t.ingest_columns(
            ints={
                "ping": ping,
                "weight": rng.choice([1, 10, 100], n).astype(np.int64),
                "time": BENCH_NOW + rng.integers(-2419200, 2419200, n),
                "index_int": np.arange(start, start + n, dtype=np.int64),
            },
            strs={"host": [HOSTS[i] for i in hosts_idx],
                  "status": [STATII[i] for i in stat_idx]})
        hosts.append(hosts_idx)
        stats.append(stat_idx)
        pings.append(ping)
    return t, flags, {"host": np.concatenate(hosts),
                      "status": np.concatenate(stats),
                      "ping": np.concatenate(pings)}


def build_sessions(root: str, n_rows: int):
    """user_sessions from scripts/fakedata/activity_generator.columns,
    1M-row steps with start_index (scripts/bench_configs.py:38-61),
    written by the port.  Returns (Table, Flags, {"action", "page":
    list indices, "weight"})."""
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    from fakedata.activity_generator import ACTIONS, PAGES, columns

    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table

    flags = Flags(dir=root, table="user_sessions", skip_compact=True,
                  device_batch=1024)
    t = Table("user_sessions", flags)
    aidx = {s: i for i, s in enumerate(ACTIONS)}
    pidx = {s: i for i, s in enumerate(PAGES)}
    acts, pages, weights = [], [], []
    for start in range(0, n_rows, STEP):
        n = min(STEP, n_rows - start)
        ints, strs = columns(n, start_index=start)
        t.ingest_columns(ints=ints, strs=strs)
        acts.append(np.fromiter((aidx[s] for s in strs["action"]),
                                dtype=np.int64, count=n))
        pages.append(np.fromiter((pidx[s] for s in strs["page"]),
                                 dtype=np.int64, count=n))
        weights.append(ints["weight"])
    return t, flags, {"action": np.concatenate(acts),
                      "page": np.concatenate(pages),
                      "weight": np.concatenate(weights)}, ACTIONS, PAGES


def numpy_groupby(hosts, pings) -> dict:
    """{host: (count, Σping)} — the straightforward reference."""
    import numpy as np
    out = {}
    for i, h in enumerate(HOSTS):
        sel = hosts == i
        out[h] = (int(sel.sum()), int(pings[sel].sum(dtype=np.int64)))
    return out


def numpy_hist(gidx, ngroups: int, matched, v, agg) -> list:
    """Per group g < ngroups: {"count": matched rows, "n": kept rows,
    "sum": Σv of kept rows, "values": bucket counts [nv], "outliers":
    raw values that overflowed their bucket range}, for an unweighted
    histogram with the port's bucket layout (AggSpec: hist_min,
    bucket_size, num_values, sub_edges, discard bounds) — the
    straightforward reference of configs 2 and 3."""
    import numpy as np
    keep = matched & (v >= agg.discard_min) & (v <= agg.discard_max)
    R = len(v)
    bv = np.zeros(R, np.int64)
    contrib = keep.copy()
    out = np.zeros(R, bool)
    if agg.sub_edges:
        assigned = np.zeros(R, bool)
        for (smin, smax, sbs, snv, soff) in agg.sub_edges:
            inr = keep & ~assigned & (v >= smin) & (v <= smax)
            raw = (v - smin) // sbs                 # v >= smin: no sign
            out |= inr & (raw >= snv)
            bv = np.where(inr, np.clip(raw, 0, snv - 1) + soff, bv)
            assigned |= inr
        contrib = assigned
    else:
        x = v - agg.hist_min
        raw = np.where(x >= 0, x // agg.bucket_size,
                       -((-x) // agg.bucket_size))
        out = keep & (raw >= agg.num_values)
        bv = np.clip(raw, 0, agg.num_values - 1)
    nv = agg.num_values
    cells = np.bincount(gidx[contrib] * nv + bv[contrib],
                        minlength=ngroups * nv).reshape(ngroups, nv)
    res = []
    for g in range(ngroups):
        sel = gidx == g
        k = sel & keep
        res.append({"count": int((sel & matched).sum()), "n": int(k.sum()),
                    "sum": int(v[k].sum(dtype=np.int64)),
                    "values": cells[g].astype(np.int64),
                    "outliers": v[sel & out]})
    return res


def str_buckets(agg, values, outliers) -> dict:
    """The JSON `buckets` of a histogram with these counts: every bucket
    keyed by its lower edge (sub-ranges in order, later keys overwriting),
    each outlier value counted once more, zeros dropped (printer.py
    result_to_json over hist.py get_str_buckets)."""
    ret = {}
    if agg.sub_edges:
        for (smin, _smax, sbs, snv, soff) in agg.sub_edges:
            for k in range(snv):
                ret[str(k * sbs + smin)] = int(values[soff + k])
    else:
        for k in range(agg.num_values):
            ret[str(k * agg.bucket_size + agg.hist_min)] = int(values[k])
    for x in outliers.tolist():
        ret[str(x)] = ret.get(str(x), 0) + 1
    return {k: c for k, c in ret.items() if c > 0}


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

class MemContainer:
    """An encoded column held in memory, with codec.Container's reads."""

    def __init__(self, meta: dict, sections: dict):
        self.meta, self._s = meta, sections

    def read(self, name):
        return self._s[name]

    def __contains__(self, name):
        return name in self._s


def k1_inputs(containers, C: int, device):
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.decode import bucket2_batch
    idx = [i for i, c in enumerate(containers) if c is not None]
    arrays = bucket2_batch(containers, idx)
    src = np.full(len(containers), -1, dtype=np.int32)
    src[idx] = np.arange(len(idx), dtype=np.int32)
    return [torch.from_numpy(a).to(device) for a in (*arrays, src)]


def max_abs_diff(a, b) -> float:
    import torch
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool:
        return float((a != b).sum().item() > 0)
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()
                 .item()) if a.numel() else 0.0


def check_equal(what: str, got, want, errs: list) -> None:
    import torch
    ok = got.shape == want.shape and torch.equal(got, want)
    err = max_abs_diff(got, want)
    errs.append(err)
    if not ok:
        fail(f"{what}: kernel differs from its plain version "
             f"(max abs diff {err})")


def k1_check(what: str, containers, C: int, device, errs: list):
    from sybil_tpu_torch.ops.decode import decode_bucket2, decode_bucket2_plain
    ins = k1_inputs(containers, C, device)
    got = decode_bucket2(*ins, C)
    want = decode_bucket2_plain(*ins, C)
    check_equal(f"K1 {what} values", got[0], want[0], errs)
    check_equal(f"K1 {what} valid", got[1], want[1], errs)
    return ins, got


def edge_containers():
    """Encoded edge blocks -> list of (label, containers, C)."""
    import numpy as np

    from sybil_tpu_torch.blocks import (IntColumnData, StrColumnData,
                                        encode_int_column, encode_str_column)
    rng = np.random.default_rng(7)

    def int_block(n, card, p_valid, spread=1):
        v = rng.integers(0, card, n).astype(np.int64) * spread
        m = rng.random(n) < p_valid
        meta, s = encode_int_column(IntColumnData(v, m))
        if meta["encoding"] != "bucket" or "seg_bases" not in s:
            fail("edge block is not bucket v2")
        return MemContainer(meta, s)

    def rare_block(n):
        # one value every ~1000 rows: gaps beyond 255 need uint16 deltas
        v = np.zeros(n, dtype=np.int64)
        v[::997] = 1
        meta, s = encode_int_column(IntColumnData(v, np.ones(n, bool)))
        if s["id_deltas"].dtype != np.uint16:
            fail("the rare-value edge block did not take uint16 deltas")
        return MemContainer(meta, s)

    def str_block(n, card):
        ids = rng.integers(0, card, n).astype(np.int32)
        m = rng.random(n) < 0.9
        meta, s = encode_str_column(
            StrColumnData(ids, m, [str(i) for i in range(card)]))
        return MemContainer(meta, s)

    def widen(c):
        s = {k: c.read(k) for k in ("uniq", "offsets", "id_deltas",
                                    "seg_bases")}
        s["id_deltas"] = s["id_deltas"].astype(np.int32)
        return MemContainer(c.meta, s)

    u8 = int_block(65536, 5, 0.97)
    return [
        ("u8 full blocks", [u8, int_block(65536, 150, 0.99)], 65536),
        ("u16 deltas", [rare_block(65536), u8], 65536),
        ("i32 deltas", [widen(int_block(65536, 40, 0.8)), u8], 65536),
        ("short blocks", [int_block(1000, 7, 0.9), int_block(1, 1, 1.0),
                          str_block(777, 3)], 1024),
        ("missing blocks", [None, int_block(4000, 12, 0.5), None,
                            str_block(65536, 4999)], 65536),
        ("invalid rows", [int_block(65536, 3, 0.01),
                          int_block(30000, 2000, 0.5, spread=-3)], 65536),
    ]


# ---------------------------------------------------------------------------
# phase 4: K2-K5
# ---------------------------------------------------------------------------

def query_params(groups, aggs, weight="", op="avg", htype="basic",
                 filters=()):
    from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
    return QueryParams(groups=tuple(groups),
                       aggs=tuple(AggDef(a, op, htype) for a in aggs),
                       filters=tuple(FilterDef(*f) for f in filters),
                       weight_col=weight)


def bound_query(table, flags, params):
    """The port's BoundQuery with exact bounds over every block: its
    config, filter constants and regex bitsets, as run_query binds
    them."""
    from sybil_tpu_torch.query.engine import BoundQuery
    table.load_info()
    b = BoundQuery(table, params, dataclasses.replace(flags))
    infos = table.block_infos()
    b.apply_exact_bounds(infos, list(infos))
    return b


def bound_config(table, flags, groups, aggs, weight=""):
    return bound_query(table, flags, query_params(groups, aggs,
                                                  weight)).config


def decoded_cols(table, names, C: int, device):
    """{name: (values, valid)} of every block, decoded by K1."""
    from sybil_tpu_torch import blocks
    from sybil_tpu_torch.ops.decode import decode_column_batch
    dirs = sorted(table.block_infos())
    out = {}
    for name in names:
        typ = table.schema.col_type(name)
        cs = [blocks.open_column(d, typ, name) for d in dirs]
        v, m, _ = decode_column_batch(cs, C, device)
        out[name] = (v, m)
    return out, dirs


def scan_check(what, cfg, cols, nrec, errs, fv=None, bits=()):
    """K2, then K4 and K5 per histogram aggregation, then K3, each against
    its plain version on the same inputs; the kernels' buffer against
    scan_packed's.  -> (K2 outputs, main)."""
    import torch

    from sybil_tpu_torch.ops import scan
    scan.check_supported(cfg)
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    dev = nrec.device
    if fv is None:
        fv = torch.zeros(0, dtype=torch.int64, device=dev)
    k2 = scan.dense_scan(cfg, cols, nrec, fv, bits)
    k2p = scan.dense_scan_plain(cfg, cols, nrec, fv, bits)
    for key in ("sums", "spill", "mins", "maxs", "gid"):
        if (k2[key] is None) != (k2p[key] is None):
            fail(f"K2 {what} {key}: kernel and plain disagree on presence")
        if k2[key] is not None:
            check_equal(f"K2 {what} {key}", k2[key], k2p[key],
                        errs["dense_scan"])
    layout = scan.packed_layout(cfg, R)
    shape = (layout["rows"], layout["W"])
    main = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    main_p = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    hists, nouts = [], []
    for ai in scan.hist_aggs(cfg):
        h = scan.dense_hist(cfg, ai, cols, k2["gid"])
        hp = scan.dense_hist_plain(cfg, ai, cols, k2["gid"])
        for key in ("hist", "out_mask", "out_val", "nout"):
            if h[key] is not None:
                check_equal(f"K4 {what} agg{ai} {key}", h[key], hp[key],
                            errs["dense_hist"])
        hists.append(h["hist"])
        nouts.append(h["nout"])
        if cfg.track_outliers:
            off, kmax = layout[f"out{ai}"]
            scan.outlier_compact(cfg, cols, h["out_mask"], h["out_val"],
                                 main, off)
            scan.outlier_compact_plain(cfg, cols, h["out_mask"],
                                       h["out_val"], main_p, off)
            check_equal(f"K5 {what} agg{ai} rows", main[off: off + kmax],
                        main_p[off: off + kmax], errs["outlier_compact"])
    scan.dense_pack(cfg, k2, hists, nouts, main, R)
    scan.dense_pack_plain(cfg, k2, hists, nouts, main_p, R)
    check_equal(f"K3 {what} main", main, main_p, errs["dense_pack"])
    packed, _ = scan.scan_packed(cfg, cols, nrec, fv, bits)
    if not torch.equal(packed["main"], main):
        fail(f"{what}: scan_packed's buffer differs from the kernels' own")
    return k2, main


EDGE_SCANS = {
    # name: (group key bounds, n aggs, weight, vbias, i32, extra)
    "no groups": ([], 1, False, False, False, {}),
    "MISSING keys, invalid values": ([(0, 5)], 2, False, False, False, {}),
    "invalid and zero weights": ([(0, 5)], 2, True, False, False, {}),
    "negative int keys": ([(-4, 6), (0, 2), (-1, 3)], 2, False, True,
                          False, {}),
    "three keys, weight, vbias, i32": ([(0, 5), (0, 3), (10, 6)], 3, True,
                                       True, True, {}),
    "near 8192 slots": ([(0, 90), (0, 89)], 1, True, False, False, {}),
    "g+1 == slots (not compact)": ([(0, 126)], 2, False, True, True, {}),
    "spill": ([(0, 3), (0, 4)], 1, False, False, False, {"spill": True}),
    "partial blocks": ([(0, 5)], 2, True, False, False, {"partial": True}),
    "lanes equal to samples skipped": ([(0, 5)], 2, False, True, True,
                                       {"nrows": True}),
    # histogram and filter edges: "hist" lists the aggs' layouts
    # ((hist_min, bucket_size, nv, discard_min, discard_max), "multi" or
    # None for avg), "filters" (col, op, kind, constant)
    "int gt and lt filters": ([(0, 5)], 1, False, False, False,
                              {"hist": [(0, 10, 20, 0, 400)],
                               "filters": [("fi", "gt", "int", 10),
                                           ("fi", "lt", "int", 70)]}),
    "int eq, str neq filters": ([(0, 5)], 1, False, False, False,
                                {"hist": [(0, 10, 20, 0, 400)],
                                 "filters": [("fi", "eq", "int", 7),
                                             ("fs", "neq", "str", 4)]}),
    "int neq, str eq filters": ([(0, 5)], 1, True, False, False,
                                {"hist": [(0, 10, 20, 0, 400)],
                                 "filters": [("fi", "neq", "int", 7),
                                             ("fs", "eq", "str", 4)]}),
    "never-ingested str eq": ([(0, 5)], 1, False, False, False,
                              {"hist": [(0, 10, 20, 0, 400)],
                               "filters": [("fs", "eq", "str", -1)]}),
    "never-ingested str neq": ([(0, 5)], 1, False, False, False,
                               {"hist": [(0, 10, 20, 0, 400)],
                                "filters": [("fs", "neq", "str", -1)]}),
    "regex re and nre": ([(0, 5)], 2, False, False, False,
                         {"hist": [(0, 10, 20, 0, 400), None],
                          "filters": [("fs", "re", "str", 0),
                                      ("fs", "nre", "str", 1)]}),
    "unknown filter op": ([(0, 5)], 1, False, False, False,
                          {"hist": [(0, 10, 20, 0, 400)],
                           "filters": [("fi", "in", "int", 3)]}),
    "weighted hist, negative values": ([(0, 5), (0, 3)], 1, True, False,
                                       False,
                                       {"hist": [(0, 7, 30, -150, 400)]}),
    "multihist sub-outliers": ([(0, 5)], 2, True, False, False,
                               {"hist": ["multi", (0, 10, 20, 0, 400)]}),
    "outliers beyond the packed rows": ([(0, 5)], 1, False, False, False,
                                        {"hist": [(0, 10, 20, 0, 400)],
                                         "max_out": 16}),
    "hist table in global memory": ([(0, 90), (0, 89)], 1, True, False,
                                    False,
                                    {"hist": [(0, 40, 12, 0, 400)],
                                     "hist_prefix": 8}),
    "hist, no groups": ([], 1, True, False, False,
                        {"hist": [(0, 10, 20, 0, 400)]}),
    "hist, not compact": ([(0, 126)], 1, False, False, False,
                          {"hist": [(0, 10, 20, 0, 400)]}),
}
MULTI_EDGES = ((200, 300, 8, 20, 0), (100, 199, 4, 20, 20),
               (0, 99, 3, 30, 40))   # top range first; 70 buckets


def edge_scan(name: str, device, B: int = 3, C: int = 65536):
    """A synthetic dense-scan batch -> (ScanConfig, cols, nrec,
    filter_vals, bitsets)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.scan import AggSpec, FilterSpec, ScanConfig
    bounds, A, weight, vbias, i32, extra = EDGE_SCANS[name]
    rng = np.random.default_rng(len(name))
    R = B * C
    cols, groups, aggs = {}, [], []

    def put(col, v, m):
        cols[col] = (torch.from_numpy(v.reshape(B, C)).to(device),
                     torch.from_numpy(m.reshape(B, C)).to(device))

    for i, (mn, card) in enumerate(bounds):
        hi = card + 1 if extra.get("spill") else card
        put(f"k{i}", rng.integers(mn, mn + hi, R).astype(np.int64),
            rng.random(R) < 0.9)
        groups.append(f"k{i}")
    hist = extra.get("hist", [None] * A)
    for a in range(A):
        lo, hi = -50 * a, 200 + 100 * a
        m = (np.ones(R, bool) if extra.get("nrows")
             else rng.random(R) < 0.85)
        if hist[a] is None:
            put(f"v{a}", rng.integers(lo - 20, hi + 40, R).astype(np.int64),
                m)
            aggs.append(AggSpec(f"v{a}", hist_min=lo, bucket_size=0,
                                num_values=0, discard_min=lo,
                                discard_max=hi))
            continue
        put(f"v{a}", rng.integers(-200, 700, R).astype(np.int64), m)
        if hist[a] == "multi":
            aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                num_values=70, discard_min=0,
                                discard_max=650, sub_edges=MULTI_EDGES))
        else:
            hmin, bs, nv, dmin, dmax = hist[a]
            aggs.append(AggSpec(f"v{a}", hist_min=hmin, bucket_size=bs,
                                num_values=nv, discard_min=dmin,
                                discard_max=dmax))
    filters, fvals = [], []
    if "filters" in extra:
        put("fi", rng.integers(0, 80, R).astype(np.int64),
            rng.random(R) < 0.9)
        put("fs", rng.integers(0, 10, R).astype(np.int64),
            rng.random(R) < 0.9)
        for col, op, kind, val in extra["filters"]:
            filters.append(FilterSpec(col, op, kind,
                                      {"re": 0, "nre": 1}.get(op, -1)))
            fvals.append(val)
    bits = tuple(torch.from_numpy(np.array([i % k == 0 for i in range(10)]))
                 .to(device) for k in (3, 4))
    wmax = 1
    if weight:
        put("w", rng.integers(0, 101, R).astype(np.int64),
            rng.random(R) < 0.8)
        wmax = 100
    rb, nrows = (), ()
    if i32:
        rb = [wmax, 1]
        for a in aggs:
            rb += [1, wmax, wmax * (a.discard_max - a.discard_min)]
    if extra.get("nrows"):
        nrows = [not weight, True]
        for _ in aggs:
            nrows += [True, not weight, False]
    cfg = ScanConfig(group_cols=tuple(groups), aggs=tuple(aggs),
                     filters=tuple(filters),
                     weight_col="w" if weight else "",
                     key_bounds=tuple(bounds),
                     agg_vbias=(tuple(a.discard_min for a in aggs)
                                if vbias else ()),
                     lane_row_bounds=tuple(rb), lane_nrows=tuple(nrows),
                     track_outliers="hist" in extra,
                     max_out=extra.get("max_out", 1024),
                     hist_prefix=extra.get("hist_prefix", 128))
    nrec = np.full(B, C, dtype=np.int32)
    if extra.get("partial"):
        nrec[:] = [0, 700, 1]
    fv = torch.tensor(fvals, dtype=torch.int64, device=device)
    return cfg, cols, torch.from_numpy(nrec).to(device), fv, bits


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def run_cli(argv):
    """The port's CLI in-process with the launch counts reset just before
    and read just after -> (rc, stdout, wall s, launches)."""
    from sybil_tpu_torch import cli
    from sybil_tpu_torch.ops import kernels
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    return rc, buf.getvalue(), wall, dict(kernels.LAUNCHES)


def snapshot(qr):
    """Everything a query result holds, histograms included."""
    import numpy as np
    rows = {}
    for k, r in qr.results.items():
        hs = {}
        for c, h in r.hists.items():
            hs[c] = (h.count, h.avg, h.min, h.max,
                     tuple(np.asarray(getattr(h, "values", ())).tolist()),
                     tuple(getattr(h, "outliers", ()) or ()),
                     tuple(h.get_percentiles()) if h.percentile_mode
                     else ())
        rows[k] = (r.count, r.samples, hs)
    return rows, qr.cumulative.count, qr.matched_count


def phase_lines(card, label, run, clear):
    """The engine's phase timer line of one cold and one warm query."""
    from sybil_tpu_torch import debug as dbg
    for kind in ("cold", "warm"):
        if kind == "cold":
            clear()
        err = io.StringIO()
        dbg.DEBUG_FLAG = True
        with contextlib.redirect_stderr(err):
            run()
        dbg.DEBUG_FLAG = False
        line = [x for x in err.getvalue().splitlines()
                if "QUERY TIMING" in x][-1]
        say(f"[{card}] {label} {kind} query phases: "
            + line.split("QUERY TIMING ", 1)[1])


def timed_queries(card, label, table, params, qflags, rows, B, expect):
    """Cold and warm walls (median of 5), no decode when warm, and a
    three-batch pipeline equal to the one-batch query.  expect: kernel ->
    launches per batch of a warm query.  -> the last warm result."""
    import torch

    from sybil_tpu_torch.ops import kernels, residency
    from sybil_tpu_torch.query.engine import run_query
    table.load_info()
    cold = []
    for _ in range(5):
        residency.CACHE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_query(table, params, qflags)
        cold.append(time.perf_counter() - t0)
    kernels.reset_launches()
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        qr = run_query(table, params, qflags)
        warm.append(time.perf_counter() - t0)
    wl = dict(kernels.LAUNCHES)
    if wl["decode_bucket2"] != 0:
        fail(f"{label}: warm queries ran the decode kernel: {wl}")
    for k, n in expect.items():
        if wl[k] != 5 * n:
            fail(f"{label}: warm queries: expected {k} {n}x per batch: {wl}")
    if B > 2:
        nb = -(-B // 3)
        nbatch = -(-B // nb)
        kernels.reset_launches()
        multi = run_query(table, params, dataclasses.replace(
            qflags, device_batch=nb))
        ml = dict(kernels.LAUNCHES)
        for k, n in expect.items():
            if ml[k] != nbatch * n:
                fail(f"{label}: {nbatch}-batch query: expected {k} {n}x "
                     f"per batch: {ml}")
        if snapshot(multi) != snapshot(qr):
            fail(f"{label}: the {nbatch}-batch query differs from the "
                 f"one-batch query")
        say(f"{label}: {nbatch}-batch query (device_batch={nb}) == "
            f"one-batch query; launches {ml}")
    say(f"[{card}] {label} cold query wall median of 5: "
        f"{median(cold) * 1e3:.3f} ms ({rows / median(cold):.0f} rows/s); "
        f"walls {[round(x * 1e3, 3) for x in cold]}")
    say(f"[{card}] {label} warm query wall median of 5: "
        f"{median(warm) * 1e3:.3f} ms ({rows / median(warm):.0f} rows/s); "
        f"walls {[round(x * 1e3, 3) for x in warm]}; warm launches {wl}")
    phase_lines(card, label, lambda: run_query(table, params, qflags),
                residency.CACHE.clear)
    return qr


def check_hist_json(label, rows, agg, want, keys_of, group_cols):
    """The CLI's -json rows of a histogram query against numpy_hist."""
    got = {tuple(r[g] for g in group_cols): r for r in rows}
    expect = {keys_of(g): w for g, w in enumerate(want) if w["count"]}
    if set(got) != set(expect):
        fail(f"{label}: groups differ: {sorted(got)} vs {sorted(expect)}")
    col = agg.col
    nout = 0
    for k, w in expect.items():
        r = got[k]
        h = r[col]
        if (r["Count"] != w["count"] or r["Samples"] != w["count"]
                or h["samples"] != w["n"] or h["avg"] != w["sum"] / w["n"]):
            fail(f"{label} group {k}: port Count={r['Count']} "
                 f"samples={h['samples']} avg={h['avg']} vs numpy "
                 f"count={w['count']} n={w['n']} sum={w['sum']}")
        if h["buckets"] != str_buckets(agg, w["values"], w["outliers"]):
            fail(f"{label} group {k}: bucket counts differ from numpy")
        if len(h["percentiles"]) != 100:
            fail(f"{label} group {k}: {len(h['percentiles'])} percentiles")
        nout += len(w["outliers"])
    return len(expect), nout


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8_388_608)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from sybil_tpu_torch.ops import kernels, residency, scan
    from sybil_tpu_torch.ops.decode import decode_bucket2, decode_bucket2_plain
    from sybil_tpu_torch.ops.residency import device_const
    from sybil_tpu_torch.query.engine import run_query

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi
    say(smi)
    t0 = time.perf_counter()
    kernels.build()
    say(f"[{card}] built {len(kernels.SOURCES)} kernels with nvcc in "
        f"{time.perf_counter() - t0:.3f}s")
    if tuple(sorted(kernels.SOURCES)) != tuple(sorted(KERNELS)):
        fail(f"kernel sources {kernels.SOURCES} are not {KERNELS}")
    for name in kernels.SOURCES:
        with open(os.path.join(kernels.BUILD_DIR, name + ".log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # ---- phase 2 ---------------------------------------------------
        t0 = time.perf_counter()
        table, flags, up = build_table(os.path.join(root, "up"), args.rows)
        nblocks = len(table.block_infos())
        say(f"built uptime table: {args.rows} rows, {nblocks} blocks in "
            f"{time.perf_counter() - t0:.1f}s (host CPU)")
        t0 = time.perf_counter()
        stable, sflags, us, actions, pages = build_sessions(
            os.path.join(root, "us"), args.rows)
        say(f"built user_sessions table: {args.rows} rows, "
            f"{len(stable.block_infos())} blocks in "
            f"{time.perf_counter() - t0:.1f}s (host CPU)")
        C = 65536 if args.rows > 8192 else 128
        while C < min(args.rows, 65536):
            C *= 2
        errs = {k: [] for k in KERNELS}

        # ---- phase 3: K1 -------------------------------------------------
        from sybil_tpu_torch import blocks
        dirs = sorted(table.block_infos())
        k1_main = {}
        for name in ("host", "ping"):
            typ = table.schema.col_type(name)
            cs = [blocks.open_column(d, typ, name) for d in dirs]
            ins, got = k1_check(f"table {name}", cs, C, dev,
                                errs["decode_bucket2"])
            k1_main[name] = (ins, cs)
            # and against the host decoder of the block store
            for bi in (0, len(cs) - 1):
                host = (blocks.decode_int_container(cs[bi])
                        if name == "ping" else
                        blocks.decode_str_container(cs[bi]))
                hv = host.values if name == "ping" else host.ids
                n = len(hv)
                if not (np.array_equal(got[0][bi, :n].cpu().numpy(), hv)
                        and np.array_equal(got[1][bi, :n].cpu().numpy(),
                                           host.valid)):
                    fail(f"K1 table {name} block {bi} differs from the "
                         f"host decoder")
        edges = edge_containers()
        for label, cs, cc in edges:
            k1_check(label, cs, cc, dev, errs["decode_bucket2"])
        say(f"K1 decode_bucket2 == plain (tolerance 0) on the table's host "
            f"and ping columns and {len(edges)} edge batches: "
            + ", ".join(label for label, _, _ in edges))

        # ---- phase 4: K2-K5 ----------------------------------------------
        cols, _ = decoded_cols(table, ["host", "ping", "status", "weight"],
                               C, dev)
        B = len(dirs)
        R = B * C
        nrec_np = np.array([table.block_infos()[d].num_records
                            for d in dirs], dtype=np.int32)
        nrec = torch.from_numpy(nrec_np).to(dev)
        configs = {
            "host/avg ping": (["host"], ["ping"], ""),
            "host/avg ping, weight column": (["host"], ["ping"], "weight"),
            "host,status,weight/avg ping,weight,ping":
                (["host", "status", "weight"], ["ping", "weight", "ping"],
                 ""),
            "host/avg weight (vbias)": (["host"], ["weight"], ""),
        }
        cfg1 = None
        for label, (g, a, w) in configs.items():
            cfg = bound_config(table, flags, g, a, w)
            sub = {k: cols[k] for k in set(g) | set(a) | ({w} - {""})}
            scan_check(label, cfg, sub, nrec, errs)
            plan = scan.dense_table_plan(cfg, R)
            say(f"K2/K3 == plain: {label}: slots={cfg.dense_slots} "
                f"Sc={scan.reduce_space(cfg)[1]} "
                f"path={scan.dense_scan_path(cfg)} i32={plan['i32']} "
                f"vbias={cfg.agg_vbias}")
            if cfg1 is None:
                cfg1 = cfg
        if scan.dense_scan_path(bound_config(
                table, flags, *configs["host,status,weight/avg ping,"
                                       "weight,ping"])) != "global":
            fail("the three-key config did not take the global-atomic path")
        part = nrec_np.copy()
        part[0] = 0
        part[-1] = min(part[-1], 1000)
        sub1 = {k: cols[k] for k in ("host", "ping")}
        scan_check("partial blocks", cfg1, sub1,
                   torch.from_numpy(part).to(dev), errs)
        kb = list(cfg1.key_bounds)
        kb[0] = (0, 3)
        narrow = dataclasses.replace(cfg1, key_bounds=tuple(kb))
        k2n, _ = scan_check("spilling key bound", narrow, sub1, nrec, errs)
        if int(k2n["spill"].item()) <= 0:
            fail("the narrowed key bound did not spill")

        # configs 3 and 2 as run_query binds them
        c3_filters = (("status", "eq", "200", "str"),)
        c2_filters = (("action", "neq", "pageload", "str"),
                      ("weight", "gt", "5", "int"))
        hist_q = {
            "config 3": (table, flags, query_params(
                ["host"], ["ping"], op="hist", filters=c3_filters)),
            "config 3 -loghist": (table, flags, query_params(
                ["host"], ["ping"], op="hist", htype="multi",
                filters=c3_filters)),
            "config 2": (stable, sflags, query_params(
                ["action", "page"], ["weight"], op="hist",
                filters=c2_filters)),
        }
        scols, sdirs = decoded_cols(stable, ["action", "page", "weight"], C,
                                    dev)
        snrec = torch.from_numpy(np.array(
            [stable.block_infos()[d].num_records for d in sdirs],
            dtype=np.int32)).to(dev)
        bound = {}
        for label, (t, f, params) in hist_q.items():
            b = bound_query(t, f, params)
            bound[label] = b
            src, n_ = (scols, snrec) if t is stable else (cols, nrec)
            sub = {k: src[k] for k in b.needed_cols}
            fv = device_const(b.filter_vals, dev)
            bits = tuple(device_const(x, dev) for x in b.bitsets)
            k2, main = scan_check(label, b.config, sub, n_, errs, fv, bits)
            agg = b.config.aggs[0]
            say(f"K2/K4/K5/K3 == plain: {label}: slots="
                f"{b.config.dense_slots} Sc={scan.reduce_space(b.config)[1]}"
                f" nv={agg.num_values} subs={len(agg.sub_edges)} "
                f"K2 path={scan.dense_scan_path(b.config)} K4 path="
                f"{scan.dense_hist_path(b.config, 0)} track_outliers="
                f"{b.config.track_outliers} groups={int(main[0, 0])} "
                f"nout={int(main[0, 2])}")
        for label in EDGE_SCANS:
            cfg, ecols, enrec, efv, ebits = edge_scan(label, dev)
            k2e, emain = scan_check(label, cfg, ecols, enrec, errs, efv,
                                    ebits)
            if (int(k2e["spill"].item()) > 0) != (label == "spill"):
                fail(f"edge scan {label}: unexpected spill "
                     f"{k2e['spill'].item()}")
            if label == "outliers beyond the packed rows" and \
                    int(emain[0, 2]) <= 16:
                fail(f"edge scan {label}: only {int(emain[0, 2])} outliers")
            if label == "hist table in global memory" and \
                    scan.dense_hist_path(cfg, 0) != "global":
                fail(f"edge scan {label}: K4 took the shared path")
        say(f"K2-K5 == plain on {len(EDGE_SCANS)} synthetic edge batches "
            f"(3 x 65536 rows): " + ", ".join(EDGE_SCANS))
        say("K2 dense_scan, K4 dense_hist, K5 outlier_compact and K3 "
            "dense_pack == plain, word for word (tolerance 0)")

        # ---- phase 5: the main path ------------------------------------
        launches = {k: 0 for k in KERNELS}
        want = numpy_groupby(up["host"], up["ping"])
        argv_q = ["query", "-dir", table.flags.dir, "-table", "uptime",
                  "-group", "host", "-int", "ping", "-op", "avg", "-json",
                  "-device-batch", str(B), "-device", "cuda"]
        residency.CACHE.clear()
        rc, out, cli_wall, l1 = run_cli(argv_q)
        if rc != 0:
            fail(f"port CLI query exited {rc}")
        if any(l1[k] == 0 for k in ("decode_bucket2", "dense_scan",
                                    "dense_pack")):
            fail(f"a kernel of the config-1 path never launched: {l1}")
        rows = json.loads(out)
        got = {r["host"]: r for r in rows}
        if set(got) != set(want):
            fail(f"groups differ: {sorted(got)} vs {sorted(want)}")
        for h, (cnt, s) in want.items():
            r = got[h]
            if r["Count"] != cnt or r["Samples"] != cnt or r["ping"] != s / cnt:
                fail(f"group {h}: port {r} vs numpy count={cnt} sum={s}")
        say(f"main path: CLI query group by host avg ping on cuda == numpy "
            f"group-by ({len(want)} groups, {args.rows} rows); launches "
            f"{l1}; wall {cli_wall:.3f}s")
        for k in KERNELS:
            launches[k] += l1[k]

        hist_argv = {
            "config 3": ["-group", "host", "-int", "ping", "-op", "hist",
                         "-str-filter", "status:eq:200"],
            "config 3 -loghist": ["-group", "host", "-int", "ping", "-op",
                                  "hist", "-str-filter", "status:eq:200",
                                  "-loghist"],
            "config 2": ["-group", "action,page", "-int", "weight", "-op",
                         "hist", "-str-filter", "action:neq:pageload",
                         "-int-filter", "weight:gt:5"],
        }
        residency.CACHE.clear()
        for label, extra in hist_argv.items():
            t, _, _ = hist_q[label]
            tname = "user_sessions" if t is stable else "uptime"
            nb = len(t.block_infos())
            rc, out, wall, ll = run_cli(
                ["query", "-dir", t.flags.dir, "-table", tname, *extra,
                 "-json", "-device-batch", str(nb), "-device", "cuda"])
            if rc != 0:
                fail(f"{label}: port CLI query exited {rc}")
            agg = bound[label].config.aggs[0]
            if t is stable:
                gidx = us["action"] * len(pages) + us["page"]
                matched = (us["action"] != actions.index("pageload")) & \
                    (us["weight"] > 5)
                wanth = numpy_hist(gidx, len(actions) * len(pages), matched,
                                   us["weight"], agg)
                ng, nout = check_hist_json(
                    label, json.loads(out), agg, wanth,
                    lambda g: (actions[g // len(pages)],
                               pages[g % len(pages)]), ("action", "page"))
            else:
                wanth = numpy_hist(up["host"], len(HOSTS),
                                   up["status"] == STATII.index("200"),
                                   up["ping"], agg)
                ng, nout = check_hist_json(
                    label, json.loads(out), agg, wanth,
                    lambda g: (HOSTS[g],), ("host",))
            if ll["dense_scan"] != 1 or ll["dense_pack"] != 1 or \
                    ll["dense_hist"] != 1:
                fail(f"{label}: expected K2, K4 and K3 once: {ll}")
            if ll["outlier_compact"] != int(bound[label].config
                                            .track_outliers):
                fail(f"{label}: K5 launches {ll} vs track_outliers "
                     f"{bound[label].config.track_outliers}")
            say(f"main path: CLI {label} on cuda == numpy group-by ({ng} "
                f"groups, {args.rows} rows, count, sum, bucket counts, "
                f"{nout} outliers); launches {ll}; wall {wall:.3f}s")
            for k in KERNELS:
                launches[k] += ll[k]
        missing = [k for k in KERNELS if launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")
        say(f"main path launches over the four CLI queries: {launches}")

        # cold/warm walls, no decode when warm, the batch pipeline
        qflags = dataclasses.replace(flags, device="cuda", device_batch=B)
        params1 = query_params(["host"], ["ping"])
        qr = timed_queries(card, "config 1", table, params1, qflags,
                           args.rows, B, {"dense_scan": 1, "dense_pack": 1,
                                          "dense_hist": 0,
                                          "outlier_compact": 0})
        for h, (cnt, s) in want.items():
            r = qr.results[h + "\t"]
            if r.count != cnt or r.hists["ping"].avg != s / cnt:
                fail(f"warm query group {h} differs from numpy")
        for label, (t, f, params) in hist_q.items():
            nb = len(t.block_infos())
            track = int(bound[label].config.track_outliers)
            timed_queries(card, label, t, params, dataclasses.replace(
                f, device="cuda", device_batch=nb), args.rows, nb,
                {"dense_scan": 1, "dense_hist": 1, "dense_pack": 1,
                 "outlier_compact": track})

        # ---- phase 6: kernel times --------------------------------------
        ins, cs = k1_main["ping"]
        deltas, counts = ins[0], ins[1]
        Kk = ins[3].shape[1]
        live = int(counts.sum().item())
        k1_bytes = (live * deltas.element_size() + B * Kk * (4 + 8 + 4)
                    + B * 4 * 2 + R * 9)
        k1_ms = cuda_ms(lambda: decode_bucket2(*ins, C))
        k1_plain = cuda_ms(lambda: decode_bucket2_plain(*ins, C), iters=5)
        k1_ops = live * 20

        def k2_bytes(cfg, sub):
            # every referenced column read once (9 B a row), the gid
            # written when K4 follows, nrec, and the tables written
            Sc = scan.reduce_space(cfg)[1]
            L = 2 + 3 * len(cfg.aggs)
            H = len(scan.hist_aggs(cfg))
            return (len(sub) * R * 9 + (R * 4 if H else 0) + B * 4
                    + Sc * (L + 2 * H) * 8 + 8)

        def k2_ops(cfg):
            # integer operations a row needs: block range test, each
            # filter's compare, each key's digit (test, subtract, clamp,
            # multiply-add), each aggregation's lanes (tests, adds, a
            # multiply) and min/max
            return R * (6 + 3 * len(cfg.filters) + 8 * len(cfg.group_cols)
                        + 12 * len(cfg.aggs)
                        + 2 * len(scan.hist_aggs(cfg)))

        # K2 on three shapes: config 1 (the PR-1 row), config 3, config 2
        c3 = bound["config 3"]
        c3l = bound["config 3 -loghist"]
        c2 = bound["config 2"]
        c3cols = {k: cols[k] for k in c3.needed_cols}
        c3fv = device_const(c3.filter_vals, dev)
        c2cols = {k: scols[k] for k in c2.needed_cols}
        c2fv = device_const(c2.filter_vals, dev)
        k2_times = {}
        for label, cfg, sub, fv, nr in (
                ("config 1", cfg1, sub1, None, nrec),
                ("config 3", c3.config, c3cols, c3fv, nrec),
                ("config 2", c2.config, c2cols, c2fv, snrec)):
            ms = cuda_ms(lambda: scan.dense_scan(cfg, sub, nr, fv))
            pms = cuda_ms(lambda: scan.dense_scan_plain(
                cfg, sub, nr, fv if fv is not None else
                torch.zeros(0, dtype=torch.int64, device=dev)), iters=5)
            k2_times[label] = (ms, pms, k2_bytes(cfg, sub), k2_ops(cfg))
            say(f"[{card}] dense_scan {label}: {ms:.4f} ms (bound "
                f"{k2_bytes(cfg, sub) / HBM_BYTES_PER_S * 1e3:.4f} ms bytes, "
                f"{k2_ops(cfg) / INT32_OPS_PER_S * 1e3:.4f} ms ops; plain "
                f"{pms:.4f} ms)")
        # one torch call over the config-1 rows: index_add_ of prebuilt
        # lanes into the same slots (host digit = dict id + 1, missing = 0)
        Sc1 = scan.reduce_space(cfg1)[1]
        L1 = 2 + 3 * len(cfg1.aggs)
        hv, hm = cols["host"]
        gid1 = torch.where(hm, hv + 1, 0).reshape(-1)
        lanes = torch.ones((R, L1), dtype=torch.int64, device=dev)
        k2_lib = cuda_ms(lambda: torch.zeros(
            (Sc1, L1), dtype=torch.int64, device=dev).index_add_(
                0, gid1, lanes), iters=5)
        # the same yardstick at config 3: K2's own gids, 5 lanes
        Sc3 = scan.reduce_space(c3.config)[1]
        L3 = 2 + 3 * len(c3.config.aggs)
        gid3 = scan.dense_scan(c3.config, c3cols, nrec, c3fv)["gid"].to(
            torch.int64)
        lanes = torch.ones((R, L3), dtype=torch.int64, device=dev)
        k2_lib3 = cuda_ms(lambda: torch.zeros(
            (Sc3, L3), dtype=torch.int64, device=dev).index_add_(
                0, gid3, lanes), iters=5)
        del lanes, gid1, gid3

        # K4 on config 3 (and, in the text, -loghist and config 2)
        k4_times = {}
        for label, b, sub, fv, nr in (
                ("config 3", c3, c3cols, c3fv, nrec),
                ("config 3 -loghist", c3l, c3cols, c3fv, nrec),
                ("config 2", c2, c2cols, c2fv, snrec)):
            cfg = b.config
            gid = scan.dense_scan(cfg, sub, nr, fv)["gid"]
            ms = cuda_ms(lambda: scan.dense_hist(cfg, 0, sub, gid))
            pms = cuda_ms(lambda: scan.dense_hist_plain(cfg, 0, sub, gid),
                          iters=5)
            Sc = scan.reduce_space(cfg)[1]
            nv = cfg.aggs[0].num_values
            track = cfg.track_outliers
            # gid, value and validity read once; counts written; the
            # outlier mask and values written when tracked
            nbytes = R * (4 + 9) + Sc * nv * 8 + (R * 9 + 8 if track else 0)
            # per row: dead test, valid, discard bounds, subtract, divide,
            # range tests, clamp, index multiply-add, add; a multihist
            # tests each sub-range it passes
            ops = R * (12 + 4 * len(cfg.aggs[0].sub_edges))
            # one torch call: index_add_ of prebuilt weights into flat
            # gid * nv + bv ids (rows that do not count go to a spare id)
            hist0 = scan.dense_hist_plain(cfg, 0, sub, gid)["hist"]
            v0, m0 = sub[cfg.aggs[0].col]
            keep = (gid != Sc - 1) & m0.reshape(-1)
            bv, inr, _ = scan.hist_bucket_plain(cfg.aggs[0], v0.reshape(-1))
            keep &= inr & (v0.reshape(-1) >= cfg.aggs[0].discard_min) & \
                (v0.reshape(-1) <= cfg.aggs[0].discard_max)
            ids = torch.where(keep, gid.to(torch.int64) * nv + bv, Sc * nv)
            ones = torch.ones(R, dtype=torch.int64, device=dev)
            lib = cuda_ms(lambda: torch.zeros(
                Sc * nv + 1, dtype=torch.int64, device=dev).index_add_(
                    0, ids, ones), iters=5)
            got_lib = torch.zeros(Sc * nv + 1, dtype=torch.int64,
                                  device=dev).index_add_(0, ids, ones)
            if not torch.equal(got_lib[:-1].reshape(Sc, nv), hist0):
                fail(f"K4 {label}: the index_add_ yardstick computes "
                     f"another function")
            del ids, ones, keep, bv, inr
            k4_times[label] = (ms, pms, nbytes, ops, lib)
            say(f"[{card}] dense_hist {label}: {ms:.4f} ms (bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms bytes, "
                f"{ops / INT32_OPS_PER_S * 1e3:.4f} ms ops; plain "
                f"{pms:.4f} ms; index_add_ {lib:.4f} ms)")

        # K5 on config 3 -loghist (tracked sub-outliers)
        cfg5 = c3l.config
        if not cfg5.track_outliers:
            fail("config 3 -loghist does not track outliers")
        gid5 = scan.dense_scan(cfg5, c3cols, nrec, c3fv)["gid"]
        h5 = scan.dense_hist(cfg5, 0, c3cols, gid5)
        lay5 = scan.packed_layout(cfg5, R)
        main5 = torch.zeros((lay5["rows"], lay5["W"]), dtype=torch.int64,
                            device=dev)
        off5, kmax5 = lay5["out0"]
        mask5, val5 = h5["out_mask"], h5["out_val"]
        k5_ms = cuda_ms(lambda: scan.outlier_compact(
            cfg5, c3cols, mask5, val5, main5, off5), iters=50)
        k5_plain = cuda_ms(lambda: scan.outlier_compact_plain(
            cfg5, c3cols, mask5, val5, main5, off5), iters=5)
        hv5, hm5 = c3cols["host"]

        def k5_lib():
            idx = torch.nonzero(mask5).reshape(-1)[:kmax5]
            return torch.stack([torch.where(hm5.reshape(-1)[idx],
                                            hv5.reshape(-1)[idx], -1),
                                val5[idx]], dim=1)
        k5_lib_ms = cuda_ms(k5_lib, iters=20)
        n5 = int(h5["nout"].item())
        # the mask read once; the selected rows' key, validity and value
        # read; the section written
        k5_bytes = R + min(n5, kmax5) * (9 + 8) + kmax5 * lay5["W"] * 8
        k5_ops = R * 2 + kmax5 * lay5["W"]
        say(f"[{card}] outlier_compact config 3 -loghist: {k5_ms:.4f} ms "
            f"({n5} outliers, kmax {kmax5}; plain {k5_plain:.4f} ms; "
            f"nonzero+gather {k5_lib_ms:.4f} ms)")

        # K3 on config 3
        c3k2 = scan.dense_scan(c3.config, c3cols, nrec, c3fv)
        c3h = scan.dense_hist(c3.config, 0, c3cols, c3k2["gid"])
        lay3 = scan.packed_layout(c3.config, R)
        main3 = torch.empty((lay3["rows"], lay3["W"]), dtype=torch.int64,
                            device=dev)
        k3_args = (c3.config, c3k2, [c3h["hist"]], [c3h["nout"]], main3, R)
        k3_ms = cuda_ms(lambda: scan.dense_pack(*k3_args), iters=200)
        k3_plain = cuda_ms(lambda: scan.dense_pack_plain(*k3_args), iters=50)
        nv3 = c3.config.aggs[0].num_values
        k3_bytes = (Sc3 * (L3 + 2) * 8 + Sc3 * nv3 * 8 + 16
                    + lay3["rows"] * lay3["W"] * 8)
        say(f"[{card}] dense_pack config 3: {k3_ms:.4f} ms (plain "
            f"{k3_plain:.4f} ms, {k3_bytes} B)")
        # and on config 1, the PR-1 shape (no hist sections)
        k2c1 = scan.dense_scan(cfg1, sub1, nrec)
        lay1 = scan.packed_layout(cfg1, R)
        main1 = torch.empty((lay1["rows"], lay1["W"]), dtype=torch.int64,
                            device=dev)
        k3c1 = cuda_ms(lambda: scan.dense_pack(cfg1, k2c1, [], [], main1, R),
                       iters=200)
        say(f"[{card}] dense_pack config 1 (PR-1 shape): {k3c1:.4f} ms")

        k2c3 = k2_times["config 3"]
        k4c3 = k4_times["config 3"]
        rows_out = []
        for name, rep, ms, pms, nbytes, ops, lib in (
                ("decode_bucket2", "sybil_tpu/ops/decode.py:86", k1_ms,
                 k1_plain, k1_bytes, k1_ops, None),
                ("dense_scan", "sybil_tpu/ops/scan.py:629", k2c3[0],
                 k2c3[1], k2c3[2], k2c3[3], k2_lib3),
                ("dense_hist", "sybil_tpu/ops/scan.py:497", k4c3[0],
                 k4c3[1], k4c3[2], k4c3[3], k4c3[4]),
                ("outlier_compact", "sybil_tpu/ops/scan.py:1802", k5_ms,
                 k5_plain, k5_bytes, k5_ops, k5_lib_ms),
                ("dense_pack", "sybil_tpu/ops/scan.py:1825", k3_ms,
                 k3_plain, k3_bytes, 0, None)):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            rows_out.append({
                "name": name, "route": "cuda",
                "source": f"sybil_tpu_torch/csrc/{name}.cu",
                "replaces": rep, "launches": launches[name],
                "max_abs_err": max(errs[name]) if errs[name] else 0.0,
                "ms": ms, "plain_ms": pms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib})
            say(f"[{card}] {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
                f"{rows_out[-1]['bound_by']}: {nbytes} B, {ops} int ops; "
                f"plain {pms:.4f} ms"
                + (f"; library {lib:.4f} ms" if lib is not None else "")
                + ")")
        say(f"[{card}] dense_scan config 1 (PR-1 shape): "
            f"{k2_times['config 1'][0]:.4f} ms; index_add_ over prebuilt "
            f"lanes {k2_lib:.4f} ms")
        say(json.dumps({"kernels": rows_out}))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
