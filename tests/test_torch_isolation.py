"""The port stands alone: no file of sybil_tpu_torch/ (nor chip_smoke.py)
imports jax or sybil_tpu, and a process that refuses both imports runs
port queries to the end, a mesh query and the row store included."""

import ast
import json
import os
import subprocess
import sys

import numpy as np

from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.table import Table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "sybil_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "sybil_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_port_source_imports_jax_or_reference():
    sources = _port_sources()
    assert len(sources) > 20
    for mod in (("query", "cache.py"), ("parallel", "mesh.py"),
                ("parallel", "multihost.py"), ("native", "__init__.py"),
                ("columnar.py",), ("digest.py",)):
        assert os.path.join(REPO, "sybil_tpu_torch", *mod) in sources
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


BLOCKER = """
import importlib.abc, sys
FORBIDDEN = {forbidden!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in FORBIDDEN):
            raise ImportError("import of " + name + " refused")
        return None

for mod in list(sys.modules):
    if any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN):
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
for name in FORBIDDEN:
    try:
        __import__(name)
    except ImportError:
        continue
    raise SystemExit("the import hook let " + name + " through")
sys.argv = ["sybil_tpu_torch"] + {argv!r}
import runpy
runpy.run_module("sybil_tpu_torch", run_name="__main__")
"""


def test_port_query_runs_with_jax_and_reference_refused(tmp_path):
    d = str(tmp_path / "db")
    t = Table("uptime", Flags(dir=d, table="uptime", skip_compact=True))
    rng = np.random.default_rng(3)
    n = 3000
    t.ingest_columns(ints={"ping": rng.integers(0, 150, n)},
                     strs={"host": [f"h{i}" for i in rng.integers(0, 4, n)]})
    argv = ["query", "-dir", d, "-table", "uptime", "-group", "host",
            "-int", "ping", "-op", "avg", "-json", "-device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN,
                                              argv=argv)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    assert sum(r["Count"] for r in rows) == n
    assert {r["host"] for r in rows} == {"h0", "h1", "h2", "h3"}


def test_port_hist_query_runs_with_jax_and_reference_refused(tmp_path):
    """The filter front end, the histogram and outlier kernels' plain
    versions and the hist printer run in the refusing process too."""
    d = str(tmp_path / "db")
    t = Table("uptime", Flags(dir=d, table="uptime", skip_compact=True))
    rng = np.random.default_rng(4)
    n = 3000
    t.ingest_columns(ints={"ping": rng.integers(0, 150, n)},
                     strs={"host": [f"h{i}" for i in rng.integers(0, 4, n)],
                           "status": [f"s{i}" for i in
                                      rng.integers(0, 3, n)]})
    argv = ["query", "-dir", d, "-table", "uptime", "-group", "host",
            "-int", "ping", "-op", "hist", "-loghist", "-str-filter",
            "status:neq:s1", "-int-filter", "ping:gt:10", "-json",
            "-device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN,
                                              argv=argv)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    assert {r["host"] for r in rows} == {"h0", "h1", "h2", "h3"}
    assert all(r["ping"]["samples"] == r["Count"] for r in rows)
    assert all(len(r["ping"]["percentiles"]) == 100 for r in rows)


def test_port_node_protocol_runs_with_jax_and_reference_refused(tmp_path):
    """The enumerated strategy's plain versions (K7's enum form, K11, K12,
    K10's enum_pack), -encode-results and `aggregate` (parallel/) run in
    the refusing process too."""
    from sybil_tpu_torch import digest
    rng = np.random.default_rng(5)
    n = 9000
    old = digest.CHUNK_SIZE
    digest.CHUNK_SIZE = 512              # 18 blocks: the device prune
    try:
        for p in (1, 2):
            d = str(tmp_path / f"db{p}")
            Table("z", Flags(dir=d, table="z", skip_compact=True)
                  ).ingest_columns(
                ints={"w": rng.integers(1, 9, n)},
                strs={"u": [f"u{i}" for i in rng.permutation(n)]})
    finally:
        digest.CHUNK_SIZE = old
    env = dict(os.environ, PYTHONPATH=REPO)
    q = ["-table", "z", "-group", "u", "-int", "w", "-limit", "3"]
    res = tmp_path / "res"
    res.mkdir()
    for p in (1, 2):
        argv = ["query", "-dir", str(tmp_path / f"db{p}"), *q,
                "-encode-results", "-device", "cpu"]
        proc = subprocess.run(
            [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN,
                                                  argv=argv)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            input="", timeout=300)
        assert proc.returncode == 0, proc.stderr
        (res / f"n{p}.json").write_text(proc.stdout)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(
            forbidden=FORBIDDEN, argv=["aggregate", *q[2:], "-json",
                                       str(res)])],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        input="", timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    assert len(rows) == 3 and all(r["Count"] >= 1 for r in rows)


def test_port_set_filter_samples_run_with_jax_and_reference_refused(tmp_path):
    """Set columns in the loader, K14's plain version, the set ops and the
    matched mask of K2's plain version, and the sample read-back run in the
    refusing process too."""
    d = str(tmp_path / "db")
    t = Table("uptime", Flags(dir=d, table="uptime", skip_compact=True))
    rng = np.random.default_rng(6)
    n = 3000
    t.ingest_columns(
        ints={"ping": rng.integers(0, 150, n),
              "index_int": np.arange(n)},
        strs={"host": [f"h{i}" for i in rng.integers(0, 4, n)]},
        sets={"groups": [[g for m, g in ((2, "mod2"), (3, "mod3"))
                          if i % m == 0] or ["none"] for i in range(n)]})
    argv = ["query", "-dir", d, "-table", "uptime", "-samples", "-limit",
            "5", "-set-filter", "groups:in:mod3,groups:nin:mod2", "-json",
            "-device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN,
                                              argv=argv)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    assert [r["index_int"] for r in rows] == [3, 9, 15, 21, 27]
    assert all(r["groups"] == ["mod3"] for r in rows)


def test_port_cached_query_runs_with_jax_and_reference_refused(tmp_path):
    """The query cache (query/cache.py, the cache-group key in K2's plain
    version, the vgroup split) runs in the refusing process too: a write,
    then a hit of every group, with the same answer."""
    from sybil_tpu_torch import digest
    d = str(tmp_path / "db")
    rng = np.random.default_rng(7)
    n = 40 * 64
    old = digest.CHUNK_SIZE
    digest.CHUNK_SIZE = 64                # 40 full blocks: two groups
    try:
        Table("uptime", Flags(dir=d, table="uptime", skip_compact=True)
              ).ingest_columns(
            ints={"ping": rng.integers(0, 150, n)},
            strs={"host": [f"h{i}" for i in rng.integers(0, 4, n)]})
    finally:
        digest.CHUNK_SIZE = old
    argv = ["query", "-dir", d, "-table", "uptime", "-group", "host",
            "-int", "ping", "-op", "avg", "-json", "-cache-queries",
            "-device-batch", "64", "-device", "cpu"]
    # the port's cache counts a 64-row block as full
    code = BLOCKER.replace(
        "import runpy\n",
        "import runpy\nimport sybil_tpu_torch.query.cache as qc\n"
        "qc.CHUNK_SIZE = 64\n")
    env = dict(os.environ, PYTHONPATH=REPO, DEBUG="1")
    outs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", code.format(forbidden=FORBIDDEN,
                                               argv=argv)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append((json.loads(proc.stdout), proc.stderr))
    assert outs[0][0] == outs[1][0]
    assert sum(r["Count"] for r in outs[0][0]) == n
    assert "query cache: 2 group hits" in outs[1][1]
    assert len([f for f in os.listdir(os.path.join(d, "uptime", "cache"))
                if f.startswith("q_")]) == 2


def test_port_mesh_query_runs_with_jax_and_reference_refused(tmp_path):
    """The mesh scan (parallel/mesh.py: the plain versions of K15, K16 and
    K12's two-valued form, the local exchange) and K3's keyed form run in
    the refusing process too, with the unsharded answer."""
    from sybil_tpu_torch import digest
    d = str(tmp_path / "db")
    rng = np.random.default_rng(8)
    n = 6000
    old = digest.CHUNK_SIZE
    digest.CHUNK_SIZE = 512              # 12 blocks over 4 shards
    try:
        Table("uptime", Flags(dir=d, table="uptime", skip_compact=True)
              ).ingest_columns(
            ints={"ping": rng.integers(0, 150, n)},
            strs={"host": [f"h{i}" for i in rng.integers(0, 4, n)]})
    finally:
        digest.CHUNK_SIZE = old
    argv = ["query", "-dir", d, "-table", "uptime", "-group", "host",
            "-int", "ping", "-op", "hist", "-json", "-device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = []
    for extra in (["-data-shards", "4"], []):
        proc = subprocess.run(
            [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN,
                                                  argv=argv + extra)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout))
    assert sum(r["Count"] for r in outs[0]) == n
    key = lambda r: r["host"]  # noqa: E731
    for a, b in zip(sorted(outs[0], key=key), sorted(outs[1], key=key)):
        assert a["Count"] == b["Count"]
        assert a["ping"]["percentiles"] == b["ping"]["percentiles"]


def test_port_row_store_runs_with_jax_and_reference_refused(tmp_path):
    """The row store runs in the refusing process too: `ingest
    -skip-compact` into the WAL, a -read-log query over it (the port's
    native WAL decoder, the pseudo-blocks, K3's keyed form of their own
    table), `digest`, and the same query without -read-log after it."""
    d = str(tmp_path / "db")
    rng = np.random.default_rng(9)
    n = 2000
    lines = "".join(json.dumps({"host": f"h{i}", "ping": int(p)}) + "\n"
                    for i, p in zip(rng.integers(0, 4, n),
                                    rng.integers(0, 150, n)))
    env = dict(os.environ, PYTHONPATH=REPO)
    query = ["query", "-dir", d, "-table", "uptime", "-group", "host",
             "-int", "ping", "-op", "avg", "-json", "-device", "cpu"]
    outs = []
    for argv, stdin in (
            (["ingest", "-dir", d, "-table", "uptime", "-skip-compact"],
             lines),
            (query + ["-read-log"], ""),
            (["digest", "-dir", d, "-table", "uptime"], ""),
            (query, "")):
        proc = subprocess.run(
            [sys.executable, "-c", BLOCKER.format(forbidden=FORBIDDEN,
                                                  argv=argv)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            input=stdin, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    rows = json.loads(outs[1])
    assert sum(r["Count"] for r in rows) == n
    assert {r["host"] for r in rows} == {"h0", "h1", "h2", "h3"}
    assert json.loads(outs[3]) == rows


def test_port_host_tools_run_with_jax_and_reference_refused(tmp_path):
    """`rebuild` of a lost table info, `query -export` and a query through
    the client API run in the refusing process too."""
    from sybil_tpu_torch import digest
    d = str(tmp_path / "db")
    rng = np.random.default_rng(10)
    n = 3000
    old = digest.CHUNK_SIZE
    digest.CHUNK_SIZE = 1024             # 3 blocks
    try:
        Table("uptime", Flags(dir=d, table="uptime", skip_compact=True)
              ).ingest_columns(
            ints={"ping": rng.integers(0, 150, n)},
            strs={"host": [f"h{i}" for i in rng.integers(0, 4, n)]})
    finally:
        digest.CHUNK_SIZE = old
    for f in ("info.json", "info.json.bak"):
        if os.path.exists(os.path.join(d, "uptime", f)):
            os.unlink(os.path.join(d, "uptime", f))
    script = BLOCKER.split("sys.argv = ")[0] + f"""
import contextlib, io, json
from sybil_tpu_torch import cli
from sybil_tpu_torch.api import SybilConfig, SybilTable
d = {d!r}
assert cli.main(["rebuild", "-dir", d, "-table", "uptime"]) == 0
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main(["query", "-dir", d, "-table", "uptime", "-export",
                     "-group", "host", "-device", "cpu"]) == 0
rows = (SybilTable(SybilConfig(dir=d, table="uptime", device="cpu"))
        .query().read_row_log(False).group_by("host").aggregate("ping")
        .execute())
print(json.dumps(rows))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script.format(forbidden=FORBIDDEN)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(proc.stdout)
    assert sum(r["Count"] for r in rows) == n
    assert {r["host"] for r in rows} == {"h0", "h1", "h2", "h3"}
    exported = os.listdir(os.path.join(d, "uptime", "export"))
    assert len(exported) == 3 and all(f.endswith(".tsv.gz")
                                      for f in exported)
