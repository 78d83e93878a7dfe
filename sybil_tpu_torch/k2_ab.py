"""Time K2 (dense_scan) of one checkout of this package on the card.

    python sybil_tpu_torch/k2_ab.py ROOT [ROOT ...]

For each ROOT (a directory holding a `sybil_tpu_torch` package, such as
the repo itself or an unpacked parent commit), a fresh process imports
that package, builds its kernels and times its dense_scan over
synthetic 8,388,608-row batches shaped like config 1 (`group by host,
avg ping`) and config 3 (`status eq 200, group by host, hist ping`),
CUDA events over 20 launches.  Give the roots in turns (parent, change,
change, parent) to compare two versions on one card.
"""

from __future__ import annotations

import os
import subprocess
import sys


def time_root(root: str) -> str:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import kernels, scan
    if not scan.__file__.startswith(root):
        raise SystemExit(f"imported {scan.__file__}, not the one under "
                         f"{root}")
    kernels.build()
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
    c1 = scan.ScanConfig(group_cols=("host",),
                         aggs=(scan.AggSpec("ping", 0, 0, 0, 0, 200),),
                         filters=(), key_bounds=((0, 5),))
    c3 = scan.ScanConfig(group_cols=("host",),
                         aggs=(scan.AggSpec("ping", 0, 1, 166, 0, 165),),
                         filters=(scan.FilterSpec("status", "eq", "str"),),
                         key_bounds=((0, 5),))
    fv = torch.tensor([0], dtype=torch.int64, device=dev)

    def ms(fn, iters=20):
        for _ in range(3):
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

    t1 = ms(lambda: scan.dense_scan(
        c1, {k: cols[k] for k in ("host", "ping")}, nrec))
    t3 = ms(lambda: scan.dense_scan(c3, cols, nrec, fv))
    return (f"{root}: K2 config-1 shape {t1:.4f} ms, config-3 shape "
            f"{t3:.4f} ms")


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(time_root(os.path.abspath(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in argv:
        # one process per root: each imports its own package
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
