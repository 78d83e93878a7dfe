#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sybil_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Phases (any failure exits non-zero before the result lines):
  1. print the card's name and power limit (nvidia-smi); build the CUDA
     kernels from sybil_tpu_torch/csrc, one nvcc per source, in parallel
  2. build an uptime table of N rows (default 8,388,608 = 128 full
     blocks) with the port's Table.ingest_columns and bench.py's
     generator and seed
  3. K1 decode_bucket2 against its plain PyTorch version on the card,
     bit for bit: the table's real host and ping containers, then edge
     blocks (u8/u16/i32 deltas, short, missing, invalid rows)
  4. K2 dense_scan and K3 dense_pack against their plain versions, word
     for word, on the decoded batch: group by host avg ping, a weight
     column, three keys whose sum table exceeds shared memory (the
     global-atomic form), a value-biased int32-packed config, partial
     blocks, and a spilling key bound; then synthetic edge batches
     (MISSING and negative keys, invalid and out-of-bound values, zero
     and invalid weights, no groups, near 8192 slots, non-compact tables)
  5. the main path: `query -group host -int ping -op avg -json` through
     the port's CLI on cuda, one batch of all blocks, with the launch
     counts reset just before and read just after; every group's count,
     ping sum and printed avg against a numpy group-by of the generated
     arrays; then cold and warm queries through run_query, checking via
     the counts that warm queries run no decode (residency) and K2/K3
     once per batch, also through a three-batch pipeline
  6. timings: query walls (median of 5) and rows/s, and the engine's
     phase breakdown of one cold and one warm query; each kernel's time
     from CUDA events beside its bound (bytes / 3.35 TB/s), its plain
     version's time and, for K2, torch's index_add_ over prebuilt lanes

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 1 first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM CUDA-core peak, for the ops bound
HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
BENCH_SEED = 1337               # bench.py:59 (fresh table)
BENCH_NOW = 1_755_000_000
STEP = 1_000_000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 2: the table
# ---------------------------------------------------------------------------

def build_table(root: str, n_rows: int):
    """bench.py build_dataset's generator and seed, written by the port.
    Returns (Table, Flags, host index per row, ping per row)."""
    import numpy as np

    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table

    flags = Flags(dir=root, table="uptime", skip_compact=True,
                  device_batch=1024)
    t = Table("uptime", flags)
    rng = np.random.default_rng(BENCH_SEED)
    hosts, pings = [], []
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
        pings.append(ping)
    return t, flags, np.concatenate(hosts), np.concatenate(pings)


def numpy_groupby(hosts, pings) -> dict:
    """{host: (count, Σping)} — the straightforward reference."""
    import numpy as np
    out = {}
    for i, h in enumerate(HOSTS):
        sel = hosts == i
        out[h] = (int(sel.sum()), int(pings[sel].sum(dtype=np.int64)))
    return out


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
# phase 4: K2 and K3
# ---------------------------------------------------------------------------

def bound_config(table, flags, groups, aggs, weight=""):
    import dataclasses

    from sybil_tpu_torch.query.engine import BoundQuery
    from sybil_tpu_torch.query.spec import AggDef, QueryParams
    table.load_info()
    params = QueryParams(groups=tuple(groups),
                         aggs=tuple(AggDef(a, "avg") for a in aggs),
                         weight_col=weight)
    f = dataclasses.replace(flags)
    b = BoundQuery(table, params, f)
    infos = table.block_infos()
    b.apply_exact_bounds(infos, list(infos))
    return b.config


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


def k2k3_check(what, cfg, cols, nrec, errs):
    from sybil_tpu_torch.ops import scan
    scan.check_supported(cfg)
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    sums, spill = scan.dense_scan(cfg, cols, nrec)
    sums_p, spill_p = scan.dense_scan_plain(cfg, cols, nrec)
    check_equal(f"K2 {what} sums", sums, sums_p, errs)
    check_equal(f"K2 {what} spill", spill, spill_p, errs)
    main = scan.dense_pack(cfg, sums, spill, R)
    main_p = scan.dense_pack_plain(cfg, sums, spill, R)
    check_equal(f"K3 {what} main", main, main_p, errs)
    return sums, spill, main


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
}


def edge_scan(name: str, device, B: int = 3, C: int = 65536):
    """A synthetic dense-scan batch -> (ScanConfig, cols, nrec)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.scan import AggSpec, ScanConfig
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
    for a in range(A):
        lo, hi = -50 * a, 200 + 100 * a
        m = (np.ones(R, bool) if extra.get("nrows")
             else rng.random(R) < 0.85)
        put(f"v{a}", rng.integers(lo - 20, hi + 40, R).astype(np.int64), m)
        aggs.append(AggSpec(f"v{a}", hist_min=lo, bucket_size=0,
                            num_values=0, discard_min=lo, discard_max=hi))
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
    cfg = ScanConfig(group_cols=tuple(groups), aggs=tuple(aggs), filters=(),
                     weight_col="w" if weight else "",
                     key_bounds=tuple(bounds),
                     agg_vbias=(tuple(a.discard_min for a in aggs)
                                if vbias else ()),
                     lane_row_bounds=tuple(rb), lane_nrows=tuple(nrows))
    nrec = np.full(B, C, dtype=np.int32)
    if extra.get("partial"):
        nrec[:] = [0, 700, 1]
    return cfg, cols, torch.from_numpy(nrec).to(device)


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

    from sybil_tpu_torch import cli
    from sybil_tpu_torch.ops import kernels, residency, scan
    from sybil_tpu_torch.ops.decode import decode_bucket2, decode_bucket2_plain
    from sybil_tpu_torch.query.engine import run_query
    from sybil_tpu_torch.query.spec import AggDef, QueryParams

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
    for name in kernels.SOURCES:
        with open(os.path.join(kernels.BUILD_DIR, name + ".log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # ---- phase 2 ---------------------------------------------------
        t0 = time.perf_counter()
        table, flags, hosts, pings = build_table(root, args.rows)
        nblocks = len(table.block_infos())
        say(f"built uptime table: {args.rows} rows, {nblocks} blocks in "
            f"{time.perf_counter() - t0:.1f}s (host CPU)")
        C = 65536 if args.rows > 8192 else 128
        while C < min(args.rows, 65536):
            C *= 2
        errs = {"decode_bucket2": [], "dense_scan": [], "dense_pack": []}

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

        # ---- phase 4: K2 and K3 -------------------------------------------
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
            k2k3_check(label, cfg, sub, nrec, errs["dense_scan"])
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
        k2k3_check("partial blocks", cfg1, sub1,
                   torch.from_numpy(part).to(dev), errs["dense_scan"])
        import dataclasses
        kb = list(cfg1.key_bounds)
        kb[0] = (0, 3)
        narrow = dataclasses.replace(cfg1, key_bounds=tuple(kb))
        _, spill, _ = k2k3_check("spilling key bound", narrow, sub1, nrec,
                                 errs["dense_scan"])
        if int(spill.item()) <= 0:
            fail("the narrowed key bound did not spill")
        for label in EDGE_SCANS:
            cfg, ecols, enrec = edge_scan(label, dev)
            _, espill, _ = k2k3_check(label, cfg, ecols, enrec,
                                      errs["dense_scan"])
            if (int(espill.item()) > 0) != (label == "spill"):
                fail(f"edge scan {label}: unexpected spill {espill.item()}")
        say(f"K2/K3 == plain on {len(EDGE_SCANS)} synthetic edge batches "
            f"(3 x 65536 rows): " + ", ".join(EDGE_SCANS))
        errs["dense_pack"] = list(errs["dense_scan"])
        say("K2 dense_scan and K3 dense_pack == plain, word for word "
            "(tolerance 0)")

        # ---- phase 5: the main path ------------------------------------
        want = numpy_groupby(hosts, pings)
        argv_q = ["query", "-dir", root, "-table", "uptime", "-group",
                  "host", "-int", "ping", "-op", "avg", "-json",
                  "-device-batch", str(B), "-device", "cuda"]
        residency.CACHE.clear()
        buf = io.StringIO()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv_q)
        cli_wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if rc != 0:
            fail(f"port CLI query exited {rc}")
        if any(v == 0 for v in launches.values()):
            fail(f"a kernel of the main path never launched: {launches}")
        rows = json.loads(buf.getvalue())
        got = {r["host"]: r for r in rows}
        if set(got) != set(want):
            fail(f"groups differ: {sorted(got)} vs {sorted(want)}")
        for h, (cnt, s) in want.items():
            r = got[h]
            if r["Count"] != cnt or r["Samples"] != cnt or r["ping"] != s / cnt:
                fail(f"group {h}: port {r} vs numpy count={cnt} sum={s}")
        say(f"main path: CLI query group by host avg ping on cuda == numpy "
            f"group-by ({len(want)} groups, {args.rows} rows); launches "
            f"{launches}; wall {cli_wall:.3f}s")

        table.load_info()
        params = QueryParams(groups=("host",), aggs=(AggDef("ping", "avg"),))
        qflags = dataclasses.replace(flags, device="cuda", device_batch=B)
        cold = []
        for _ in range(5):
            residency.CACHE.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qr = run_query(table, params, qflags)
            cold.append(time.perf_counter() - t0)
        kernels.reset_launches()
        warm = []
        for _ in range(5):
            t0 = time.perf_counter()
            qr = run_query(table, params, qflags)
            warm.append(time.perf_counter() - t0)
        wl = dict(kernels.LAUNCHES)
        if wl["decode_bucket2"] != 0:
            fail(f"warm queries ran the decode kernel: {wl}")
        if wl["dense_scan"] != 5 or wl["dense_pack"] != 5:
            fail(f"warm queries: expected K2 and K3 once per batch: {wl}")
        for h, (cnt, s) in want.items():
            r = qr.results[h + "\t"]
            if r.count != cnt or r.hists["ping"].avg != s / cnt:
                fail(f"warm query group {h} differs from numpy")
        # the batch pipeline: three batches of 48 blocks, the last one
        # padded by repeating a block with nrec = 0, four in flight
        if B > 2:
            nb = -(-B // 3)
            kernels.reset_launches()
            multi = run_query(table, params, dataclasses.replace(
                qflags, device_batch=nb))
            ml = dict(kernels.LAUNCHES)
            nbatch = -(-B // nb)
            if ml["dense_scan"] != nbatch or ml["dense_pack"] != nbatch:
                fail(f"{nbatch}-batch query: expected K2/K3 once per batch: "
                     f"{ml}")
            snap = {k: (r.count, r.samples, r.hists["ping"].avg)
                    for k, r in qr.results.items()}
            if {k: (r.count, r.samples, r.hists["ping"].avg)
                    for k, r in multi.results.items()} != snap:
                fail(f"{nbatch}-batch query differs from the one-batch query")
            say(f"{nbatch}-batch query (device_batch={nb}) == one-batch "
                f"query; launches {ml}")
        say(f"[{card}] cold query wall median of 5: "
            f"{median(cold) * 1e3:.3f} ms ({args.rows / median(cold):.0f} "
            f"rows/s); walls {[round(x * 1e3, 3) for x in cold]}")
        say(f"[{card}] warm query wall median of 5: "
            f"{median(warm) * 1e3:.3f} ms ({args.rows / median(warm):.0f} "
            f"rows/s); walls {[round(x * 1e3, 3) for x in warm]}; warm "
            f"launches {wl}")

        # where a query's wall time goes: the engine's own phase timer
        # (bind / list_blocks / load / dispatch / drain / finish), one
        # cold and one warm query
        from sybil_tpu_torch import debug as dbg
        for label in ("cold", "warm"):
            if label == "cold":
                residency.CACHE.clear()
            err = io.StringIO()
            dbg.DEBUG_FLAG = True
            with contextlib.redirect_stderr(err):
                run_query(table, params, qflags)
            dbg.DEBUG_FLAG = False
            line = [x for x in err.getvalue().splitlines()
                    if "QUERY TIMING" in x][-1]
            say(f"[{card}] {label} query phases: "
                + line.split("QUERY TIMING ", 1)[1])

        # ---- phase 6: kernel times --------------------------------------
        ins, cs = k1_main["ping"]
        deltas, counts = ins[0], ins[1]
        Kk = ins[3].shape[1]
        live = int(counts.sum().item())
        k1_bytes = (live * deltas.element_size() + B * Kk * (4 + 8 + 4)
                    + B * 4 * 2 + R * 9)
        k1_ms = cuda_ms(lambda: decode_bucket2(*ins, C))
        k1_plain = cuda_ms(lambda: decode_bucket2_plain(*ins, C), iters=5)

        sub1 = {k: cols[k] for k in ("host", "ping")}
        Sc = scan.reduce_space(cfg1)[1]
        L = 2 + 3 * len(cfg1.aggs)
        k2_bytes = 2 * R * 9 + B * 4 + Sc * L * 8 + 8
        k2_ms = cuda_ms(lambda: scan.dense_scan(cfg1, sub1, nrec))
        k2_plain = cuda_ms(lambda: scan.dense_scan_plain(cfg1, sub1, nrec),
                           iters=5)
        # one torch call over the same rows: index_add_ of prebuilt lanes
        # into the same slots (host digit = dict id + 1, missing = 0)
        hv, hm = cols["host"]
        gid = torch.where(hm, hv + 1, 0).reshape(-1)
        lanes = torch.ones((R, L), dtype=torch.int64, device=dev)
        lib_ms = cuda_ms(lambda: torch.zeros(
            (Sc, L), dtype=torch.int64, device=dev).index_add_(0, gid, lanes),
            iters=5)
        del lanes, gid
        sums, spill = scan.dense_scan(cfg1, sub1, nrec)
        layout = scan.packed_layout(cfg1, R)
        k3_bytes = Sc * L * 8 + 8 + layout["rows"] * layout["W"] * 8
        k3_ms = cuda_ms(lambda: scan.dense_pack(cfg1, sums, spill, R),
                        iters=200)
        k3_plain = cuda_ms(lambda: scan.dense_pack_plain(cfg1, sums, spill,
                                                         R), iters=50)
        # integer operations per row of K2 (row test, key digits, lanes):
        # a lower bound against the CUDA-core peak
        k2_ops = R * (6 + 8 * len(cfg1.group_cols) + 12 * len(cfg1.aggs))
        k1_ops = live * 20
        rows_out = []
        for name, src, rep, ms, pms, nbytes, ops, lib in (
                ("decode_bucket2", "sybil_tpu_torch/csrc/decode_bucket2.cu",
                 "sybil_tpu/ops/decode.py:86", k1_ms, k1_plain, k1_bytes,
                 k1_ops, None),
                ("dense_scan", "sybil_tpu_torch/csrc/dense_scan.cu",
                 "sybil_tpu/ops/scan.py:629", k2_ms, k2_plain, k2_bytes,
                 k2_ops, lib_ms),
                ("dense_pack", "sybil_tpu_torch/csrc/dense_pack.cu",
                 "sybil_tpu/ops/scan.py:1825", k3_ms, k3_plain, k3_bytes,
                 0, None)):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / FP32_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            rows_out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": max(errs[name]) if errs[name] else 0.0,
                "ms": ms, "plain_ms": pms,
                "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib})
            say(f"[{card}] {name}: {ms:.4f} ms (bound {bound:.4f} ms, "
                f"{nbytes} B; plain {pms:.4f} ms"
                + (f"; index_add_ {lib:.4f} ms" if lib is not None else "")
                + ")")
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
