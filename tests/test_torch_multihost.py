"""The port's multi-process mesh: N processes, one query, one shuffle.

Mirrors tests/test_multihost.py on the port: 2 and 4 OS processes join one
torch.distributed process group (gloo, -device cpu) through the port's
CLI (-data-shards 8 -dist-coordinator/-dist-pid/-dist-nproc), each scans
its span of every batch, the shuffle's exchange runs over the group, and
process 0 prints.  Its bytes must equal the reference's 8-shard answer
(`python -m sybil_tpu query -data-shards 8`), and its rows the
single-process port's unsharded ones; every other process prints
nothing.  Tolerance 0: the JSON text is compared byte for byte, except
against the unsharded answer, which may order tied groups otherwise and
sums float means in another order (rows as a set, 1e-12 relative)."""

import contextlib
import io
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sybil_tpu import cli as ref_cli
from sybil_tpu_torch import cli as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """test_multihost's table, in blocks of 256 rows (12 blocks): a string
    key, pings, weights and a set column, written by the reference."""
    import sybil_tpu.digest as ref_digest
    from sybil_tpu.config import Flags
    from sybil_tpu.table import Table

    d = str(tmp_path_factory.mktemp("mh") / "db")
    rng = np.random.default_rng(7)
    n = 3000
    hosts = ["a.com", "b.com", "c.com", "d.com", "e.com"]
    hi = rng.integers(0, 5, n)
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 256
    try:
        Table("mh", Flags(dir=d, table="mh", skip_compact=True)
              ).ingest_columns(
            ints={"ping": rng.integers(0, 100, n).astype(np.int64),
                  "weight": rng.choice([1, 10], n).astype(np.int64),
                  "index_int": np.arange(n, dtype=np.int64)},
            strs={"host": [hosts[i] for i in hi]},
            sets={"groups": [[f"mod{k}" for k in (2, 3) if i % k == 0]
                             for i in range(n)]})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


def _query(d: str, extra: list[str]) -> list[str]:
    return ["query", "-dir", d, "-table", "mh", "-device-batch", "8",
            "-json"] + extra


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("SYBIL_DIST_COORDINATOR", None)
    return env


def _in_process(main, d: str, extra: list[str]) -> str:
    """A single-process answer, run in this process (conftest's 8 virtual
    CPU devices carry the reference's 8-shard mesh)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(_query(d, extra))
    assert rc in (0, None)
    return buf.getvalue()


def _run_nodes(d: str, nproc: int, extra: list[str]) -> list[str]:
    port = _free_port()
    procs = []
    for pid in range(nproc):
        argv = [sys.executable, "-m", "sybil_tpu_torch"] + _query(
            d, extra + ["-device", "cpu", "-data-shards", "8",
                        "-dist-coordinator", f"localhost:{port}",
                        "-dist-pid", str(pid), "-dist-nproc", str(nproc)])
        procs.append(subprocess.Popen(argv, env=_env(), cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"process {pid} failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        # a process that failed leaves its peers waiting in a collective
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _close(a, b):
    """JSON values equal, floats within 1e-12 relative."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12)
    return a == b


QUERIES = {
    "group-avg": ["-group", "host", "-int", "ping", "-op", "avg"],
    "hist-filter": ["-group", "host", "-int", "ping", "-op", "hist",
                    "-str-filter", "host:neq:a.com"],
    "hist-outliers-set": ["-group", "host", "-int", "ping", "-op", "hist",
                          "-loghist", "-set-filter", "groups:in:mod3"],
    "distinct-weight": ["-group", "host", "-distinct", "weight",
                        "-weight-col", "weight"],
    "samples": ["-samples", "-limit", "5", "-int-filter", "ping:gt:90"],
}


@pytest.mark.parametrize("nproc,name", [
    (2, "group-avg"), (2, "hist-filter"), (2, "hist-outliers-set"),
    (2, "distinct-weight"), (2, "samples"), (4, "group-avg"),
    (4, "hist-outliers-set")])
def test_multi_process_mesh_matches_single(table, nproc, name):
    extra = QUERIES[name]
    outs = _run_nodes(table, nproc, extra)
    assert all(o == "" for o in outs[1:]), "only process 0 may print"
    want = _in_process(ref_cli.main, table, extra + ["-data-shards", "8"])
    assert outs[0] == want
    # the unsharded answer may print tied groups in another order
    plain = _in_process(port_cli.main, table, extra + ["-device", "cpu"])
    rows, plain_rows = json.loads(outs[0]), json.loads(plain)
    assert rows and _close(sorted(rows, key=_row_key),
                           sorted(plain_rows, key=_row_key))


def _row_key(row: dict) -> str:
    return json.dumps({k: v for k, v in row.items()
                       if not isinstance(v, (float, dict))}, sort_keys=True)


# ---------------------------------------------------------------------------
# batch level: a dense scan's outlier rows across processes
# ---------------------------------------------------------------------------

def _outlier_case(max_out: int):
    """A dense batch whose first half holds most of the outliers (pings
    past the histogram's 140), so the processes' spans keep different
    counts of rows: 8 blocks of 256 rows, a host key of 5 values with
    some missing.  -> (port ScanConfig, cols {name: (values, valid)}
    numpy [8, 256], nrec)."""
    from sybil_tpu_torch.ops import scan as port
    B, C = 8, 256
    rng = np.random.default_rng(11)
    tail = np.where(np.arange(B)[:, None] < 4, 200, 150)
    cols = {"host": (rng.integers(0, 5, (B, C)).astype(np.int64),
                     rng.random((B, C)) > 0.1),
            "ping": ((rng.random((B, C)) * tail).astype(np.int64),
                     rng.random((B, C)) > 0.05)}
    nrec = np.array([C, C - 9, C, C, C, 0, C, C - 100], np.int32)
    cfg = port.ScanConfig(
        group_cols=("host",), filters=(),
        aggs=(port.AggSpec("ping", hist_min=0, bucket_size=10,
                           num_values=14, discard_min=0, discard_max=1400),),
        track_outliers=True, key_bounds=((0, 5),), no_compact_table=True,
        max_out=max_out)
    return cfg, cols, nrec


def _outlier_scans(mesh) -> dict:
    """This process's span of _outlier_case's batch through the port's
    sharded_scan and pack at max_out 1024 (every outlier packed) and 64
    (the escalation's fetch) -> {name: numpy} of the packed download and
    the escalation's outlier keys and values."""
    import torch

    from sybil_tpu_torch.ops import scan as port
    from sybil_tpu_torch.parallel import mesh as port_mesh
    got = {}
    for max_out in (1024, 64):
        cfg, cols, nrec = _outlier_case(max_out)
        span = slice(mesh.pid * len(nrec) // mesh.nproc,
                     (mesh.pid + 1) * len(nrec) // mesh.nproc)
        parts = port_mesh.sharded_scan(
            cfg, mesh, {k: (torch.from_numpy(v[span]),
                            torch.from_numpy(m[span]))
                        for k, (v, m) in cols.items()},
            torch.from_numpy(nrec[span]), torch.zeros(0, dtype=torch.int64),
            (), 1, {})
        got[f"main{max_out}"] = port.pack_parts(cfg, parts)["main"].numpy()
        keys, vals = port.fetch_outliers(cfg, parts["raw"], 0)
        got[f"keys{max_out}"], got[f"vals{max_out}"] = keys, vals
    return got


def _mesh_child(out_path: str) -> None:
    """One process of test_multi_process_dense_outlier_rows: joins the
    group from the SYBIL_DIST_* variables, scans its span; process 0
    writes the results."""
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.parallel import mesh as port_mesh
    from sybil_tpu_torch.parallel import multihost
    import torch.distributed as dist
    assert multihost.init_distributed(Flags(device="cpu"))
    got = _outlier_scans(port_mesh.Mesh(8, dist.group.WORLD))
    if multihost.is_printer():
        np.savez(out_path, **got)
    multihost.shutdown()


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_dense_outlier_rows(tmp_path, nproc):
    """The dense outlier rows of a multi-process mesh (each process's
    marked rows and their keys, gathered in process order) pack the
    single-process mesh's download word for word, and the escalation
    fetches the same outlier keys and values."""
    from sybil_tpu_torch.parallel import mesh as port_mesh
    port = _free_port()
    out = str(tmp_path / "got.npz")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_multihost as t; t._mesh_child(sys.argv[2])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(REPO, "tests"), out],
        env=dict(_env(), SYBIL_DIST_COORDINATOR=f"localhost:{port}",
                 SYBIL_DIST_PID=str(pid), SYBIL_DIST_NPROC=str(nproc)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    try:
        for pid, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"process {pid} failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = _outlier_scans(port_mesh.Mesh(8))
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert len(want["vals64"]) > 64       # the escalation ran
