"""The port's host tools against the reference, on CPU: `rebuild`,
`index` and `query -update-info`, `trim`, `inspect`, `query -export`,
`calculate_icc` and the client API (sybil_tpu_torch/recover.py, trim.py,
inspect_cmd.py, export.py, query/stats.py, api.py).

One table is written by the reference's ingest (several blocks, missing
values, a set column, and a second table's undigested WAL); each test runs
both packages on copies of it, or on the same files where nothing is
written, and compares what they print and write exactly: stdout, the
table's and every block's info.json, the decompressed TSVs, the API's
rows.  ICC alone is compared at 1e-12 relative.  The port's queries run
with `-device cpu` (the plain PyTorch versions of the kernels)."""

import gzip
import json
import os
import shutil

import numpy as np
import pytest

import sybil_tpu.digest as ref_digest
from sybil_tpu import api as ref_api
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.digest import digest_records as ref_digest_records
from sybil_tpu.ingest import flatten_record
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.query.stats import calculate_icc as ref_icc
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import api as port_api
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import decode, residency, scan
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, QueryParams
from sybil_tpu_torch.query.stats import calculate_icc
from sybil_tpu_torch.table import Table

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
N_ROWS = 6000
CHUNK = 1024
T0 = 1_700_000_000
CPU = ["-device", "cpu"]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """`uptime`: six blocks written by the reference (the last partial),
    ints with missing rows, two str columns, a set column; `tail`: 300
    records in the row store, undigested."""
    d = str(tmp_path_factory.mktemp("toolsdb"))
    rng = np.random.default_rng(41)
    n = N_ROWS
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = CHUNK
    try:
        RefTable("uptime", RefFlags(dir=d, table="uptime",
                                    skip_compact=True)).ingest_columns(
            ints={"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
                  "weight": rng.choice([1, 10, 100], n).astype(np.int64),
                  # time rises block by block, with some spread: trim
                  # ranks the blocks by their newest record
                  "time": T0 + np.arange(n) * 10 + rng.integers(0, 3000, n)},
            strs={"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
                  "status": [STATII[i] for i in rng.integers(0, 5, n)]},
            sets={"groups": [[g for m, g in ((2, "mod2"), (3, "mod3"))
                              if i % m == 0] or ["none"] for i in range(n)]},
            valid={"ping": rng.random(n) > 0.1, "host": rng.random(n) > 0.05})
    finally:
        ref_digest.CHUNK_SIZE = old
    RefTable("tail", RefFlags(dir=d, table="tail",
                              skip_compact=True)).ingest_records(
        [flatten_record({"host": HOSTS[i % 5], "ping": i, "time": T0 + i})
         for i in range(300)])
    return d


def _copy(db, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(db, d)
    return d


def _out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _blocks(d, table="uptime"):
    tdir = os.path.join(d, table)
    return sorted(os.path.join(tdir, b) for b in os.listdir(tdir)
                  if b.startswith("block"))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _info_files(d):
    """The table's info.json and each block's, by name."""
    out = {"info.json": _read(os.path.join(d, "uptime", "info.json"))}
    for b in _blocks(d):
        out[os.path.basename(b)] = _read(os.path.join(b, "info.json"))
    return out


QUERIES = {
    "config 1": ["-group", "host", "-int", "ping", "-op", "avg"],
    "hist, filtered": ["-group", "host", "-int", "ping,weight", "-op",
                       "hist", "-str-filter", "status:eq:200"],
    "two keys": ["-group", "host,status", "-int", "weight"],
}


def _query(d, argv):
    return ["query", "-dir", d, "-table", "uptime", *argv, "-json"]


def _drop_info(d):
    for f in ("info.json", "info.json.bak"):
        p = os.path.join(d, "uptime", f)
        if os.path.exists(p):
            os.unlink(p)


# ---------------------------------------------------------------------------
# rebuild, index, -update-info
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state,flags", [
    ("lost", []), ("present", []), ("present", ["-replace"]),
    ("empty", ["-force"])])
def test_rebuild_matches_reference(db, tmp_path, capsys, state, flags):
    """`rebuild` deduces the schema from the blocks (tests/test_cli.py's
    test_rebuild): the same info.json, and the same answer after it."""
    outs = {}
    for name, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = _copy(db, tmp_path, name)
        if state == "lost":
            _drop_info(d)
        elif state == "empty":
            for b in _blocks(d):
                shutil.rmtree(b)
            _drop_info(d)
        assert main(["rebuild", "-dir", d, "-table", "uptime",
                     *flags]) == 0
        path = os.path.join(d, "uptime", "info.json")
        info = _read(path) if os.path.exists(path) else None
        extra = CPU if name == "port" else []
        q = (_out(main, _query(d, QUERIES["config 1"]) + extra, capsys)
             if state != "empty" else "")
        outs[name] = (info, q)
    assert outs["port"] == outs["ref"]
    if state == "lost":
        rows = json.loads(outs["port"][1])
        assert sum(r["Count"] for r in rows) == N_ROWS
        assert set(json.loads(outs["port"][0])["schema"]["key_table"]) == {
            "ping", "weight", "time", "host", "status", "groups"}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_rebuild_query_in_one_process(db, tmp_path, capsys, name):
    """A query, `rebuild` (new key ids: the columns numbered by sorted
    name), the same query again, in one process: the resident columns,
    the launch plans and the block-info memo of the first query must not
    leak into the second."""
    argv = QUERIES[name]
    outs = {}
    for pkg, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = _copy(db, tmp_path, pkg)
        extra = CPU if pkg == "port" else []
        before = _out(main, _query(d, argv) + extra, capsys)
        old_ids = json.loads(_read(os.path.join(d, "uptime", "info.json")))
        _drop_info(d)
        assert main(["rebuild", "-dir", d, "-table", "uptime"]) == 0
        new_ids = json.loads(_read(os.path.join(d, "uptime", "info.json")))
        assert (old_ids["schema"]["key_table"]
                != new_ids["schema"]["key_table"])
        outs[pkg] = (before, _out(main, _query(d, argv) + extra, capsys))
    assert outs["port"] == outs["ref"]
    assert json.loads(outs["port"][0]) == json.loads(outs["port"][1])


@pytest.mark.parametrize("argv", [["index"], ["query", "-update-info"]])
def test_index_matches_reference(db, tmp_path, capsys, argv):
    """`index` and `query -update-info` rewrite the table's int stats and
    every block's info.json.  The reference's `query -update-info` writes
    them before loading the table's info (it leaves an empty schema and
    empty blocks), so the port's is held to the reference's `index`, which
    loads it first as cmd_index.go and cmd_query.go do."""
    r = _copy(db, tmp_path, "ref")
    p = _copy(db, tmp_path, "port")
    for d in (r, p):
        # stale stats, so that rewriting them shows
        for b in _blocks(d):
            path = os.path.join(b, "info.json")
            info = json.loads(_read(path))
            info["int_info"] = {}
            with open(path, "w") as f:
                json.dump(info, f)
    assert ref_cli.main(["index", "-dir", r, "-table", "uptime"]) == 0
    assert port_cli.main([argv[0], "-dir", p, "-table", "uptime",
                          *argv[1:]]) == 0
    want, got = _info_files(r), _info_files(p)
    assert got == want
    assert all(json.loads(v)["int_info"] for v in got.values()
               if not v.startswith(b'{"name"'))
    q = QUERIES["hist, filtered"]
    assert _out(port_cli.main, _query(p, q) + CPU, capsys) == \
        _out(ref_cli.main, _query(r, q), capsys)


# ---------------------------------------------------------------------------
# trim
# ---------------------------------------------------------------------------

def _trim_argvs():
    last = T0 + N_ROWS * 10
    return {"everything (tests/test_cli.py)": ["-mb", "0", "-before",
                                               "9999999999"],
            "size": ["-mb", "0"],
            "older than": ["-before", str(last - 2 * CHUNK * 10)],
            # blocks' max pings 120-133: some listed, ranked by ping
            "by ping": ["-before", "125", "-time-col", "ping"]}


@pytest.mark.parametrize("name", sorted(_trim_argvs()))
def test_trim_list_matches_reference(db, capsys, name):
    """The listing only reads: both packages on the same files."""
    argv = ["trim", "-dir", db, "-table", "uptime", *_trim_argvs()[name]]
    want = _out(ref_cli.main, argv, capsys)
    assert _out(port_cli.main, argv, capsys) == want
    if name != "size":
        assert "block" in want


def test_trim_list_by_size_matches_reference(db, tmp_path, capsys):
    """-mb with a limit that keeps some blocks: the byte budget counts the
    blocks' sizes newest first (their sizes sum past 1 MB here)."""
    d = _copy(db, tmp_path, "big")
    for b in _blocks(d):
        path = os.path.join(b, "info.json")
        info = json.loads(_read(path))
        info["size"] = 400 * 1024
        with open(path, "w") as f:
            json.dump(info, f)
    argv = ["trim", "-dir", d, "-table", "uptime", "-mb", "1"]
    want = _out(ref_cli.main, argv, capsys)
    got = _out(port_cli.main, argv, capsys)
    assert got == want
    assert 0 < len(got.splitlines()) < len(_blocks(d))


def test_trim_delete_then_query_matches_reference(db, tmp_path, capsys):
    outs = {}
    cut = str(T0 + N_ROWS * 10 - 3 * CHUNK * 10)
    for pkg, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = _copy(db, tmp_path, pkg)
        deleted = _out(main, ["trim", "-dir", d, "-table", "uptime",
                              "-before", cut, "-delete", "-really"], capsys)
        extra = CPU if pkg == "port" else []
        outs[pkg] = (deleted.replace(d, "D"), len(_blocks(d)),
                     _out(main, _query(d, QUERIES["hist, filtered"])
                          + extra, capsys))
    assert outs["port"] == outs["ref"]
    assert 0 < outs["port"][1] < N_ROWS // CHUNK + 1
    assert outs["port"][0].count("deleted") == \
        N_ROWS // CHUNK + 1 - outs["port"][1]


# ---------------------------------------------------------------------------
# inspect
# ---------------------------------------------------------------------------

def _inspect_target(d, kind, tmp_path):
    t = os.path.join(d, "uptime")
    if kind == "table info":
        return os.path.join(t, "info.json")
    if kind == "block info":
        return os.path.join(_blocks(d)[0], "info.json")
    if kind == "int column":
        return os.path.join(_blocks(d)[1], "int_ping.sy")
    if kind == "str column":
        return os.path.join(_blocks(d)[1], "str_host.sy")
    if kind == "dictionary":
        return os.path.join(t, "dicts", "host.sy")
    if kind == "WAL log":
        from sybil_tpu_torch import rowstore
        logs = rowstore.list_logs(os.path.join(d, "tail"))
        assert len(logs) == 1
        return logs[0]
    path = str(tmp_path / "junk.bin")
    with open(path, "wb") as f:
        f.write(bytes(range(256)) * 4)
    return path


@pytest.mark.parametrize("kind", ["table info", "block info", "int column",
                                  "str column", "dictionary", "WAL log",
                                  "unknown"])
def test_inspect_matches_reference(db, tmp_path, capsys, kind):
    path = _inspect_target(db, kind, tmp_path)
    want = _out(ref_cli.main, ["inspect", path], capsys)
    assert _out(port_cli.main, ["inspect", "-file", path], capsys) == want
    head = want.splitlines()[0]
    name = os.path.basename(path)
    assert head == {"table info": f"# {name}: json",
                    "block info": f"# {name}: json",
                    "WAL log": f"# {name}: row-store log, 300 records",
                    "unknown": f"# {name}: unrecognized format"}.get(
        kind, head)
    if kind in ("int column", "str column", "dictionary"):
        assert head.startswith(f"# {name}: container meta=")


# ---------------------------------------------------------------------------
# query -export
# ---------------------------------------------------------------------------

def _exported(d):
    edir = os.path.join(d, "uptime", "export")
    out = {}
    for f in sorted(os.listdir(edir)):
        with gzip.open(os.path.join(edir, f), "rt") as fh:
            out[f] = fh.read()
    return out


@pytest.mark.parametrize("fmt", ["-json", "text"])
def test_export_matches_reference(db, tmp_path, capsys, fmt):
    """`query -export` writes every block's TSV (the .gz bytes carry a
    time stamp: compare the text) and then runs the query."""
    outs = {}
    for pkg, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        d = _copy(db, tmp_path, pkg)
        argv = ["query", "-dir", d, "-table", "uptime", "-export", "-group",
                "host", "-int", "ping"] + ([fmt] if fmt != "text" else [])
        out = _out(main, argv + (CPU if pkg == "port" else []), capsys)
        outs[pkg] = (out.replace(d, "D"), _exported(d))
    assert outs["port"] == outs["ref"]
    tsvs = outs["port"][1]
    assert len(tsvs) == N_ROWS // CHUNK + 1
    header = next(iter(tsvs.values())).split("\n", 1)[0].split("\t")
    # int columns, then str columns, each by name; no set column
    assert header == ["ping", "time", "weight", "host", "status"]
    assert sum(t.count("\n") for t in tsvs.values()) == N_ROWS
    assert "EXPORTED RECORDS TO D" in outs["port"][0]


# ---------------------------------------------------------------------------
# calculate_icc (tests/test_stats.py)
# ---------------------------------------------------------------------------

def _icc_rows(case):
    rng = np.random.default_rng(7)
    rows = []
    if case == "separated":
        for g, mu in (("a", 100), ("b", 500), ("c", 900)):
            rows += [{"g": g, "v": int(rng.normal(mu, 5))}
                     for _ in range(200)]
    elif case == "single group":
        rows = [{"g": "only", "v": i % 50} for i in range(100)]
    else:
        for g in ("a", "b", "c", "d"):
            rows += [{"g": g, "v": i % 100} for i in range(250)]
    return rows


@pytest.mark.parametrize("case", ["separated", "single group", "identical"])
def test_icc_matches_reference(tmp_path, case):
    rflags = RefFlags(dir=str(tmp_path / "db"), table="icc",
                      skip_compact=True)
    rt = RefTable("icc", rflags)
    rt.ingest_records([flatten_record(r) for r in _icc_rows(case)])
    ref_digest_records(rt)
    rparams = RefParams(groups=("g",), aggs=(RefAgg("v", "hist"),))
    want = ref_icc(ref_run_query(rt, rparams, rflags), rparams)
    flags = Flags(dir=str(tmp_path / "db"), table="icc", device="cpu")
    params = QueryParams(groups=("g",), aggs=(AggDef("v", "hist"),))
    got = calculate_icc(run_query(Table("icc", flags), params, flags),
                        params)
    assert set(got) == set(want) == {"v"}
    assert np.isfinite(got["v"])
    assert abs(got["v"] - want["v"]) <= 1e-12 * abs(want["v"])
    if case == "single group":
        assert got["v"] == 1.0
    if case == "identical":
        assert got["v"] < 0.5


# ---------------------------------------------------------------------------
# the client API (tests/test_api.py)
# ---------------------------------------------------------------------------

def _people(api, d, device):
    t = api.SybilTable(api.SybilConfig(dir=d, table="people", **device))
    t.add_records([{"age": 20 + (i % 50), "state": ["CA", "NY", "TX"][i % 3],
                    "weight": 1 + (i % 3), "time": 1_700_000_000 + i}
                   for i in range(300)])
    t.flush_records()
    return t


def _api_before_digest(api, d, device):
    return _people(api, d, device).query().read_row_log(False) \
        .group_by("state").execute()


def _api_readlog(api, d, device):
    return _people(api, d, device).query().group_by("state") \
        .aggregate("age").execute()


def _api_digest_then_query(api, d, device):
    t = _people(api, d, device)
    t.digest()
    return t.query().read_row_log(False).group_by("state").execute()


def _api_filters_and_getters(api, d, device):
    rows = (_people(api, d, device).query().group_by("state")
            .int_filter_gt("age", 44).int_filter_lt("age", 47).execute())
    return rows, rows[0].str("state"), rows[0].int("Count")


def _api_str_filter_and_record_builder(api, d, device):
    t = api.SybilTable(api.SybilConfig(dir=d, table="t2", **device))
    t.add_records([api.SybilRecord().add_int("v", i)
                   .add_str("k", f"key{i % 4}").add_set("tags", [f"t{i % 2}"])
                   for i in range(40)])
    t.flush_records()
    return (t.query().str_filter_eq("k", "key1").execute(),
            t.query().str_filter_regex("k", "key[23]").execute(),
            t.query().set_filter_in("tags", "t0").execute())


def _api_time_series(api, d, device):
    return _people(api, d, device).query().time_series("time", 100) \
        .group_by("state").execute()


def _api_hist_percentiles(api, d, device):
    return _people(api, d, device).query().group_by("state") \
        .aggregate("age").hist().execute()


def _api_table_info_and_list(api, d, device):
    t = _people(api, d, device)
    t.digest()
    return t.table_info(), t.list_tables()


def _api_subprocess_mode(api, d, device):
    t = api.SybilTable(api.SybilConfig(dir=d, table="sub", **device),
                       subprocess_mode=True)
    t.add_records([{"v": i % 5, "who": f"u{i % 2}"} for i in range(20)])
    t.flush_records()
    return t.query().group_by("who").aggregate("v").execute()


API_CASES = {f.__name__[5:]: f for f in (
    _api_before_digest, _api_readlog, _api_digest_then_query,
    _api_filters_and_getters, _api_str_filter_and_record_builder,
    _api_time_series, _api_hist_percentiles, _api_table_info_and_list,
    _api_subprocess_mode)}


@pytest.mark.parametrize("case", sorted(API_CASES))
def test_api_matches_reference(tmp_path, case):
    want = API_CASES[case](ref_api, str(tmp_path / "ref"), {})
    got = API_CASES[case](port_api, str(tmp_path / "port"),
                          {"device": "cpu"})
    assert got == want
    if case == "before_digest":
        assert got == []
    else:
        assert got


def test_api_on_cuda_without_a_card_raises_and_runs_nothing(
        tmp_path, monkeypatch):
    """SybilConfig's default device is cuda: here, with no card, a query
    raises and nothing runs on the CPU instead, in process or not."""
    ran = []
    for mod in (scan, decode):
        for name in dir(mod):
            if name.endswith("_plain") and callable(getattr(mod, name)):
                monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                                    ran.append(_n))
    monkeypatch.setattr(residency.CACHE, "put",
                        lambda *a, **k: ran.append("upload"))
    d = str(tmp_path / "db")
    t = _people(port_api, d, {})
    assert t.config.device == "cuda"
    assert "-device" in t.query().argv() and \
        t.query().argv()[t.query().argv().index("-device") + 1] == "cuda"
    with pytest.raises(RuntimeError, match="exit code 1"):
        t.query().group_by("state").aggregate("age").execute()
    sub = port_api.SybilTable(port_api.SybilConfig(dir=d, table="people"),
                              subprocess_mode=True)
    with pytest.raises(RuntimeError,
                       match=r"torch.cuda.is_available\(\) is False"):
        sub.query().group_by("state").execute()
    assert ran == []
