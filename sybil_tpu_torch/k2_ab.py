"""A/B timings of checkouts of this package on the card: kernels, and
warm query walls.

    python sybil_tpu_torch/k2_ab.py ROOT [ROOT ...]
    python sybil_tpu_torch/k2_ab.py --walls DIR ROOT [ROOT ...]

Each ROOT is a directory holding a `sybil_tpu_torch` package, such as
the repo itself or an unpacked parent commit; a fresh process imports
that package and builds its kernels.  Give the roots in turns (parent,
change, change, parent) to compare two versions on one card.

Kernels (the first form): over synthetic 8,388,608-row batches shaped
like config 1 (`group by host, avg ping`) and config 3 (`status eq 200,
group by host, hist ping`): K2 on both shapes, K3 after each, K5 on
config 3's shape with outliers tracked (no live outlier row, as on the
bench table), and the sorted strategy on config 3's filter with a
packed key: K7, K8 and K10 (`avg ping`); for a root that has K14,
K14 and K2 at config 1's shape with one set filter (1 or 2 entries a
row) and the matched mask, timed beside the same launch without them;
and for a root with the query cache's cache-group key, K2 at config 1's
shape with that key (8 groups of 16 blocks) and K7 unpacked at config
3's filter with and without it.
CUDA events over 20 launches
(K3, K5 and K10 200), twice: back to back as a caller issues them
("wall", which includes the wrapper's host time whenever that exceeds
the kernel's), and behind a sleep kernel long enough that the host has
queued them all before the first starts ("device", the kernels' own
time).

Walls (`--walls`): builds chip_smoke.py's uptime table (8,388,608 rows,
bench.py's generator and seed) under DIR unless it is there, then for
each root times `run_query` of config 1 and config 3 warm (decoded
columns resident): 15 queries after 3 warm-ups, their median wall and
quartiles, and the median of each of the engine's phases over the same
15 queries.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 8_388_608


def _import_root(root: str):
    sys.path.insert(0, root)
    from sybil_tpu_torch.ops import kernels, scan
    if not scan.__file__.startswith(root):
        raise SystemExit(f"imported {scan.__file__}, not the one under "
                         f"{root}")
    kernels.build()
    return kernels, scan


def _ms(fn, iters=20, queued=False):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        # about 50 ms of cycles: long enough to queue 200 launches
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(root: str) -> str:
    import numpy as np
    import torch

    _, scan = _import_root(root)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, C = 128, 65536
    R = B * C

    def col(v, p_valid):
        return (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C))
                .to(dev),
                torch.from_numpy(rng.random(R) < p_valid).reshape(B, C)
                .to(dev))

    cols = {"host": col(rng.integers(0, 5, R), 0.93),
            "ping": col(np.abs(rng.normal(60, 20, R)).astype(np.int64),
                        0.89),
            "status": col(rng.integers(0, 5, R), 1.0)}
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    avg = scan.AggSpec("ping", 0, 0, 0, 0, 200)
    hist = scan.AggSpec("ping", 0, 1, 166, 0, 165)
    status = (scan.FilterSpec("status", "eq", "str"),)
    c1 = scan.ScanConfig(group_cols=("host",), aggs=(avg,), filters=(),
                         key_bounds=((0, 5),))
    c3 = scan.ScanConfig(group_cols=("host",), aggs=(hist,),
                         filters=status, key_bounds=((0, 5),))
    c3o = scan.ScanConfig(group_cols=("host",), aggs=(hist,),
                          filters=status, key_bounds=((0, 5),),
                          track_outliers=True)
    c7 = scan.ScanConfig(group_cols=("host",), aggs=(avg,), filters=status,
                         key_bounds=((0, 5),), force_sorted=True,
                         sort_pack=((0, 5),))
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    cols1 = {k: cols[k] for k in ("host", "ping")}

    def main_of(cfg):
        lay = scan.packed_layout(cfg, R)
        return lay, torch.zeros((lay["rows"], lay["W"]), dtype=torch.int64,
                                device=dev)

    k2c1 = scan.dense_scan(c1, cols1, nrec)
    _, main1 = main_of(c1)
    k2c3 = scan.dense_scan(c3, cols, nrec, fv)
    h3 = scan.dense_hist(c3, 0, cols, k2c3["gid"])
    _, main3 = main_of(c3)
    lay5, main5 = main_of(c3o)
    off5 = lay5["out0"][0]
    mask5 = torch.zeros(R, dtype=torch.bool, device=dev)
    val5 = cols["ping"][0].reshape(R)
    front7 = scan.sorted_front(c7, cols, nrec, fv)
    order7 = scan.sort_rows(c7, front7)
    k8 = scan.segment_reduce(c7, cols, front7, order7)
    _, main10 = main_of(c7)

    runs = (
        (f"{root}: K2 config-1 shape", 20,
         lambda: scan.dense_scan(c1, cols1, nrec)),
        ("K2 config-3 shape", 20, lambda: scan.dense_scan(c3, cols, nrec, fv)),
        ("K3 config-1 shape", 200,
         lambda: scan.dense_pack(c1, k2c1, [], [], main1, R)),
        ("K3 config-3 shape", 200,
         lambda: scan.dense_pack(c3, k2c3, [h3["hist"]], [h3["nout"]],
                                 main3, R)),
        ("K5 config-3 shape, no live outlier", 200,
         lambda: scan.outlier_compact(c3o, cols, mask5, val5, main5, off5)),
        ("K7 config-3 filter, packed key", 20,
         lambda: scan.sorted_front(c7, cols, nrec, fv)),
        ("K8 same", 20,
         lambda: scan.segment_reduce(c7, cols, front7, order7)),
        ("K10 same", 200,
         lambda: scan.sorted_pack(c7, k8, front7["spill"], [], [], main10,
                                  R)),
    )
    if hasattr(scan, "set_match"):
        import dataclasses

        from sybil_tpu_torch.query.engine import pad_set_csr
        k = rng.integers(1, 3, R)
        rows = np.repeat(np.arange(R, dtype=np.int32), k)
        prow, pval = pad_set_csr(rows, rng.integers(0, 4, len(rows)), R)
        csr = (torch.from_numpy(prow).to(dev), torch.from_numpy(pval).to(dev),
               len(rows))
        cs = dataclasses.replace(
            c1, filters=(scan.FilterSpec("groups", "in", "set"),),
            want_matched_mask=True)
        fvs = torch.tensor([1], dtype=torch.int64, device=dev)
        sm = scan.set_filter_masks(cs, fvs, {"groups": csr}, R)
        runs += (
            (f"K14 one set filter ({len(rows)} entries)", 20,
             lambda: scan.set_match(*csr, fvs, 0, R)),
            ("K2 config-1 shape with the set filter and the mask", 20,
             lambda: scan.dense_scan(cs, cols1, nrec, fvs, set_masks=sm)),
            ("K2 config-1 shape without them (the same launch)", 20,
             lambda: scan.dense_scan(c1, cols1, nrec)))
    if hasattr(scan, "has_cg"):
        import dataclasses

        # a query-cache group scan at config 1's and path 1's shapes: the
        # cache-group key (block // 16: 8 groups) ahead of host
        cg1 = dataclasses.replace(c1, group_cols=("__cg__", "host"),
                                  key_bounds=((0, B // 16), (0, 5)),
                                  vg_span=16)
        cg7 = dataclasses.replace(c7, group_cols=("__cg__", "host"),
                                  sort_pack=(), vg_span=16)
        c7u = dataclasses.replace(c7, sort_pack=())
        runs += (
            ("K2 config-1 shape with the cache-group key", 20,
             lambda: scan.dense_scan(cg1, cols1, nrec)),
            ("K7 config-3 filter, unpacked, with the cache-group key", 20,
             lambda: scan.sorted_front(cg7, cols, nrec, fv)),
            ("K7 the same without it", 20,
             lambda: scan.sorted_front(c7u, cols, nrec, fv)))
    return "; ".join(
        f"{what} {_ms(fn, n):.4f} ms wall, "
        f"{_ms(fn, n, queued=True):.4f} ms device"
        for what, n, fn in runs)


def build_walls_table(table_dir: str) -> None:
    """chip_smoke.py's uptime table under table_dir, unless it is there."""
    if os.path.isdir(os.path.join(table_dir, "uptime")):
        return
    sys.path.insert(0, REPO)
    import chip_smoke
    t0 = time.perf_counter()
    chip_smoke.build_table(table_dir, ROWS)
    print(f"built the uptime table ({ROWS} rows) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def time_walls(root: str, table_dir: str, n: int = 15) -> str:
    import dataclasses

    import numpy as np
    import torch

    _import_root(root)
    from sybil_tpu_torch import profiler
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.query.engine import run_query
    from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
    from sybil_tpu_torch.table import Table

    # each query's phase totals, as its PhaseTimer reports them
    seen = []
    report = profiler.PhaseTimer.report

    def keep(self, label="query"):
        seen.append(dict(self.totals))
        return report(self, label)

    profiler.PhaseTimer.report = keep
    flags = Flags(dir=table_dir, table="uptime", skip_compact=True,
                  device="cuda", device_batch=1024)
    table = Table("uptime", flags)
    table.load_info()
    queries = {
        "config 1": QueryParams(groups=("host",),
                                aggs=(AggDef("ping", "avg", "basic"),)),
        "config 3": QueryParams(
            groups=("host",), aggs=(AggDef("ping", "hist", "basic"),),
            filters=(FilterDef("status", "eq", "200", "str"),)),
    }
    out = []
    for label, params in queries.items():
        qflags = dataclasses.replace(flags)
        for _ in range(3):
            run_query(table, params, qflags)
        walls = []
        del seen[:]
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_query(table, params, qflags)
            walls.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(walls, [25, 50, 75])
        names = sorted({k for t in seen for k in t},
                       key=lambda k: -np.median([t.get(k, 0.0)
                                                 for t in seen]))
        phases = ", ".join(
            f"{k} {np.median([t.get(k, 0.0) for t in seen]) * 1e3:.3f}"
            for k in names)
        out.append(f"{root}: {label} warm wall median of {n} {med:.3f} ms "
                   f"(quartiles {q1:.3f}, {q3:.3f}; walls "
                   f"{[round(w, 3) for w in walls]}); phase medians, ms: "
                   f"{phases}")
    return "\n".join(out)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(time_kernels(os.path.abspath(argv[1])), flush=True)
        return 0
    if len(argv) == 3 and argv[0] == "--one-walls":
        print(time_walls(os.path.abspath(argv[1]), argv[2]), flush=True)
        return 0
    walls = bool(argv) and argv[0] == "--walls"
    roots = argv[2:] if walls else argv
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if walls:
        table_dir = os.path.abspath(argv[1])
        build_walls_table(table_dir)
    for root in roots:
        # one process per root: each imports its own package
        cmd = ([sys.executable, os.path.abspath(__file__), "--one-walls",
                root, table_dir] if walls else
               [sys.executable, os.path.abspath(__file__), "--one", root])
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
