"""The port's query path end to end against the JAX reference, on CPU.

A bench-shaped uptime table (a few blocks; hosts and pings with missing
rows) and a small user_sessions table are written by sybil_tpu.
sybil_tpu_torch's run_query and its `query -json` output must equal the
reference's: group keys, counts, samples, exact sums (through the
averages), histogram buckets, min/max, outliers and percentiles, and the
printed text byte for byte.  The on-disk format is shared both ways."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
import sybil_tpu_torch.digest as port_digest
from sybil_tpu import blocks as ref_blocks
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import FilterDef as RefFilter
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import blocks as port_blocks
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import kernels, residency
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
from sybil_tpu_torch.table import Table

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
N_ROWS = 9000
CHUNK = 2048


def _columns(seed: int):
    rng = np.random.default_rng(seed)
    n = N_ROWS
    # latency: a heavy tail (0.5% of rows 7-13x the median, 0.1% 30-100x)
    # that overflows the hist range the outlier-resistant IntInfo sets
    u = rng.random(n)
    latency = np.where(u < 0.001, rng.integers(90000, 300000, n),
                       np.where(u < 0.006, rng.integers(20000, 40000, n),
                                np.abs(rng.normal(3000, 800, n))))
    latency = latency.astype(np.int64)
    ints = {"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
            "weight": rng.choice([1, 10, 100], n).astype(np.int64),
            "index_int": np.arange(n, dtype=np.int64) % 4000,
            "latency": latency}
    strs = {"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
            "status": [STATII[i] for i in rng.integers(0, 5, n)]}
    valid = {"host": rng.random(n) > 0.07, "ping": rng.random(n) > 0.11,
             "weight": rng.random(n) > 0.2}
    return ints, strs, valid


def _ingest(table, digest_mod, seed):
    """Two bulk ingests with a small block size: the second tops up the
    first's partial block, as the digest path does."""
    old = digest_mod.CHUNK_SIZE
    digest_mod.CHUNK_SIZE = CHUNK
    try:
        ints, strs, valid = _columns(seed)
        half = N_ROWS // 2
        for lo, hi in ((0, half), (half, N_ROWS)):
            table.ingest_columns(
                ints={k: v[lo:hi] for k, v in ints.items()},
                strs={k: v[lo:hi] for k, v in strs.items()},
                valid={k: v[lo:hi] for k, v in valid.items()})
    finally:
        digest_mod.CHUNK_SIZE = old


@pytest.fixture(scope="module")
def ref_table(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("refdb"))
    t = RefTable("uptime", RefFlags(dir=d, table="uptime", skip_compact=True))
    _ingest(t, ref_digest, 11)
    return d


ACTIONS = ["pageload", "pageunload", "click", "notif", "hover", "tooltip",
           "type", "chat", "comment"]
PAGES = ["login", "home", "friends", "settings", "feed", "groups",
         "explore", "404"]


@pytest.fixture(scope="module")
def sessions_table(tmp_path_factory):
    """user_sessions as scripts/fakedata/activity_generator.py shapes it
    (action, page, weight in {1, 10, 100}), small, with missing rows."""
    d = str(tmp_path_factory.mktemp("sessdb"))
    t = RefTable("user_sessions", RefFlags(dir=d, table="user_sessions",
                                           skip_compact=True))
    rng = np.random.default_rng(23)
    n = 7000
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = CHUNK
    try:
        t.ingest_columns(
            ints={"weight": rng.choice([1, 10, 100], n).astype(np.int64)},
            strs={"action": [ACTIONS[i] for i in rng.integers(0, 9, n)],
                  "page": [PAGES[i] for i in rng.integers(0, 8, n)]},
            valid={"action": rng.random(n) > 0.05,
                   "weight": rng.random(n) > 0.1})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


# name -> (groups, aggs, weight column, op, hist type, filters
# (col, op, value, kind), table)
C2_FILTERS = (("action", "neq", "pageload", "str"),
              ("weight", "gt", "5", "int"))
QUERIES = {
    "host-avg-ping": (("host",), ("ping",), ""),
    "host-status": (("host", "status"), ("ping",), ""),
    "weight-column": (("host",), ("ping",), "weight"),
    "two-aggs": (("host",), ("ping", "weight"), ""),
    "int-group-key": (("weight",), ("ping",), ""),
    "no-groups": ((), ("ping",), ""),
    # config 3's shape: status eq 200, group by host, hist ping
    "c3-hist": (("host",), ("ping",), "", "hist", "basic",
                (("status", "eq", "200", "str"),)),
    "c3-loghist": (("host",), ("ping",), "", "hist", "multi",
                   (("status", "eq", "200", "str"),)),
    # config 2's shape on user_sessions
    "c2-sessions-hist": (("action", "page"), ("weight",), "", "hist",
                         "basic", C2_FILTERS, "user_sessions"),
    "regex-filter-weighted-hist": (("status",), ("ping",), "weight", "hist",
                                   "basic", (("host", "re", "yahoo|git",
                                              "str"),
                                             ("ping", "lt", "90", "int"))),
    "never-ingested-neq-avg": (("host",), ("ping", "weight"), "", "avg",
                               "basic", (("status", "neq", "999", "str"),
                                         ("weight", "neq", "10", "int"))),
    # values above the hist range: outlier rows (basic), sub-ranges and
    # sub-outliers (multihist)
    "tail-outliers-hist": (("status",), ("latency",), "", "hist", "basic",
                           (("ping", "gt", "40", "int"),)),
    "tail-outliers-loghist": (("host", "status"), ("latency",), "weight",
                              "hist", "multi", ()),
    # 4000 live groups > hist_prefix: the bucket-row escalation
    "index-int-hist": (("index_int",), ("ping",), "", "hist", "basic", ()),
}


def _query(name):
    q = QUERIES[name] + (None,) * (7 - len(QUERIES[name]))
    groups, aggs, w, op, htype, filters, table = q
    return (groups, aggs, w, op or "avg", htype or "basic", filters or (),
            table or "uptime")


def _params(name, agg_cls, filter_cls, params_cls):
    groups, aggs, w, op, htype, filters, _ = _query(name)
    return params_cls(
        groups=groups, aggs=tuple(agg_cls(a, op, htype) for a in aggs),
        filters=tuple(filter_cls(*f) for f in filters), weight_col=w)


def _table_dir(name, request) -> tuple[str, str]:
    table = _query(name)[6]
    fixture = "ref_table" if table == "uptime" else "sessions_table"
    return request.getfixturevalue(fixture), table


def _hist_state(h):
    """Everything a hist shows: count, mean, min/max, bucket counts,
    outliers and percentiles."""
    st = [h.count, h.avg, h.min, h.max]
    vals = getattr(h, "values", None)
    if vals is not None:
        st.append(tuple(np.asarray(vals).tolist()))
    st.append(tuple(getattr(h, "outliers", ()) or ()))
    if h.percentile_mode:
        st.append(tuple(h.get_percentiles()))
        st.append(h.get_stddev())
    return tuple(st)


def _snapshot(qr):
    rows = {}
    for k, r in qr.results.items():
        rows[k] = (tuple(r.key_tuple), r.count, r.samples,
                   {c: _hist_state(h) for c, h in r.hists.items()})
    cum = qr.cumulative
    return rows, (cum.count, cum.samples), qr.matched_count


@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_run_query_matches_reference(request, name, batch):
    d, table = _table_dir(name, request)
    want = ref_run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        _params(name, RefAgg, RefFilter, RefParams),
        RefFlags(dir=d, table=table, device_batch=batch))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=batch)
    got = run_query(Table(table, flags),
                    _params(name, AggDef, FilterDef, QueryParams), flags)
    assert _snapshot(got) == _snapshot(want)
    assert len(got.results) >= 1
    assert [r.group_key for r in got.sorted] == \
        [r.group_key for r in want.sorted]


def _exact_sums(engine_mod, monkeypatch, run):
    """{key tuple: (count, samples, ((present, Σkw, Σkw·v) per agg))} from
    the accumulator as finish() finds it (parked batches, or the rows
    they were merged into), summed in Python ints — the exact integers
    the averages are made of."""
    seen = []
    orig = engine_mod._Accumulator.finish

    def spy(self):
        self._materialize()
        seen.append({kt: (r["count"], r["samples"],
                          tuple((a is not None, a and a["count"],
                                 a and a["wv"], a and a["min"],
                                 a and a["max"],
                                 a and a["hist"] is not None
                                 and tuple(a["hist"].tolist()),
                                 a and tuple(a["outliers"]))
                                for a in r["aggs"]))
                     for kt, r in self.rows.items()})
        return orig(self)

    monkeypatch.setattr(engine_mod._Accumulator, "finish", spy)
    run()
    monkeypatch.setattr(engine_mod._Accumulator, "finish", orig)
    return seen[0]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_exact_int64_sums_match_reference(request, name, monkeypatch):
    import sybil_tpu.query.engine as ref_engine
    import sybil_tpu_torch.query.engine as port_engine
    d, table = _table_dir(name, request)
    want = _exact_sums(ref_engine, monkeypatch, lambda: ref_run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        _params(name, RefAgg, RefFilter, RefParams),
        RefFlags(dir=d, table=table, device_batch=2)))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=2)
    got = _exact_sums(port_engine, monkeypatch, lambda: run_query(
        Table(table, flags), _params(name, AggDef, FilterDef, QueryParams),
        flags))
    assert got == want and len(got) >= 1
    assert all(isinstance(v[0], int) for v in got.values())


def _cli_out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["-json", "text"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_cli_output_matches_reference_bytes(request, name, fmt, capsys):
    d, table = _table_dir(name, request)
    groups, aggs, w, op, htype, filters, _ = _query(name)
    argv = ["query", "-dir", d, "-table", table, "-op", op,
            "-int", ",".join(aggs)]
    if groups:
        argv += ["-group", ",".join(groups)]
    if w:
        argv += ["-weight-col", w]
    if htype == "multi":
        argv.append("-loghist")
    for kind in ("int", "str"):
        toks = [":".join(f[:3]) for f in filters if f[3] == kind]
        if toks:
            argv += [f"-{kind}-filter", ",".join(toks)]
    if fmt == "-json":
        argv.append("-json")
    want = _cli_out(ref_cli.main, argv, capsys)
    got = _cli_out(port_cli.main, argv + ["-device", "cpu"], capsys)
    assert got == want
    if fmt == "-json":
        assert len(json.loads(got)) >= 1


def _read_all(blocks_mod, table_dir, schema, names):
    import os
    out = []
    for entry in sorted(os.listdir(table_dir)):
        bdir = os.path.join(table_dir, entry)
        if not entry.startswith("block") or not os.path.isdir(bdir):
            continue
        info = blocks_mod.load_block_info(bdir)
        cols = blocks_mod.load_block_columns(bdir, schema, names)
        out.append((info.num_records, info.int_exact,
                    {k: (getattr(c, "values", getattr(c, "ids", None)),
                         c.valid) for k, c in cols.items()}))
    return out


def _same_blocks(a, b):
    assert len(a) == len(b)
    for (na, ea, ca), (nb, eb, cb) in zip(a, b):
        assert na == nb and ea == eb and set(ca) == set(cb)
        for k in ca:
            np.testing.assert_array_equal(ca[k][0], cb[k][0])
            np.testing.assert_array_equal(ca[k][1], cb[k][1])


def test_port_written_table_reads_back_through_reference(tmp_path):
    d = str(tmp_path)
    flags = Flags(dir=d, table="uptime", skip_compact=True, device="cpu")
    _ingest(Table("uptime", flags), port_digest, 5)
    names = ["host", "status", "ping", "weight", "index_int"]
    rt = RefTable("uptime", RefFlags(dir=d, table="uptime"))
    assert rt.load_info()
    pt = Table("uptime", flags)
    assert pt.load_info()
    assert rt.schema.to_json() == pt.schema.to_json()
    assert rt.dicts.get("host").strings == pt.dicts.get("host").strings
    _same_blocks(_read_all(ref_blocks, rt.dir, rt.schema, names),
                 _read_all(port_blocks, pt.dir, pt.schema, names))
    want = ref_run_query(rt, RefParams(groups=("host",),
                                       aggs=(RefAgg("ping", "avg"),)),
                         RefFlags(dir=d, table="uptime"))
    got = run_query(pt, QueryParams(groups=("host",),
                                    aggs=(AggDef("ping", "avg"),)), flags)
    assert _snapshot(got) == _snapshot(want)


def test_reference_written_table_reads_back_through_port(ref_table):
    names = ["host", "status", "ping", "weight", "index_int"]
    rt = RefTable("uptime", RefFlags(dir=ref_table, table="uptime"))
    pt = Table("uptime", Flags(dir=ref_table, table="uptime"))
    assert rt.load_info() and pt.load_info()
    assert [b.num_records for b in pt.block_infos().values()] == \
        [b.num_records for b in rt.block_infos().values()]
    _same_blocks(_read_all(ref_blocks, rt.dir, rt.schema, names),
                 _read_all(port_blocks, pt.dir, pt.schema, names))


def test_same_table_written_by_both_is_identical(tmp_path):
    """Same columns, same seed: the two writers produce the same blocks."""
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    _ingest(RefTable("uptime", RefFlags(dir=da, table="uptime",
                                        skip_compact=True)), ref_digest, 3)
    _ingest(Table("uptime", Flags(dir=db, table="uptime",
                                  skip_compact=True)), port_digest, 3)
    rt = RefTable("uptime", RefFlags(dir=da, table="uptime"))
    pt = Table("uptime", Flags(dir=db, table="uptime"))
    assert rt.load_info() and pt.load_info()
    names = ["host", "status", "ping", "weight", "index_int"]
    _same_blocks(_read_all(ref_blocks, rt.dir, rt.schema, names),
                 _read_all(port_blocks, pt.dir, pt.schema, names))


def test_default_device_without_cuda_raises(ref_table, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    assert Flags().device == "cuda"
    t = Table("uptime", Flags(dir=ref_table, table="uptime"))
    with pytest.raises(kernels.DeviceUnavailable, match="device cpu"):
        run_query(t, QueryParams(groups=("host",),
                                 aggs=(AggDef("ping", "avg"),)), t.flags)
    rc = port_cli.main(["query", "-dir", ref_table, "-table", "uptime",
                        "-group", "host", "-int", "ping", "-json"])
    assert rc == 1
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


@pytest.mark.parametrize("change,item", [
    ({"read_log": True}, "A13"),
    ({"cache_queries": True}, "A13"),
    ({"data_shards": 2}, "A14"),
])
def test_unported_engine_modes_raise(ref_table, change, item):
    flags = dataclasses.replace(
        Flags(dir=ref_table, table="uptime", device="cpu"), **change)
    with pytest.raises(NotImplementedError, match=item):
        run_query(Table("uptime", flags),
                  QueryParams(groups=("host",),
                              aggs=(AggDef("ping", "avg"),)), flags)


@pytest.mark.parametrize("argv,item", [
    (["-set-filter", "tags:in:a"], "B6b"),
    # -tdigest, a rollup past DENSE_WINDOW_SLOT_CAP (4000 quotients x 6 x
    # 6 slots) and int keys past the dense slot cap take the sorted
    # strategy, which tests/test_torch_sorted.py holds against the
    # reference; on it samples stay unported.  The device prune (B10) and
    # count distinct (B9) are ported: those cases now print the
    # reference's bytes (the enumerated strategy, tests/test_torch_enum.py;
    # the distinct pairs of a rollup and the device HLL,
    # tests/test_torch_distinct.py)
    (["-op", "hist", "-tdigest", "-samples"], "A13"),
    (["-time", "-time-col", "index_int", "-time-bucket", "1", "-group",
      "host,status", "-distinct", "weight"], "B9"),
    (["-distinct", "status"], "B9"),
    (["-group", "index_int,weight"], "B10"),
])
def test_unported_query_shapes_exit_with_roadmap_item(ref_table, argv, item,
                                                      capsys, tmp_path):
    d = ref_table
    if "-set-filter" in argv:
        # set filters need a set column: a small table of the port's own
        d = str(tmp_path)
        Table("uptime", Flags(dir=d, table="uptime",
                              skip_compact=True)).ingest_columns(
            ints={"ping": np.arange(6)}, strs={"host": ["a", "b"] * 3},
            sets={"tags": [["a"], ["b", "a"], [], ["c"], ["a"], ["b"]]})
    if item == "B10":
        # the device prune asks for more than 16 blocks: a table of the
        # port's own, whose exact int keys pack into one sort key
        d = str(tmp_path)
        old = port_digest.CHUNK_SIZE
        port_digest.CHUNK_SIZE = 64
        try:
            Table("uptime", Flags(dir=d, table="uptime",
                                  skip_compact=True)).ingest_columns(
                ints={"ping": np.arange(1100) % 90,
                      "index_int": np.arange(1100) * 7,
                      "weight": np.arange(1100) % 3})
        finally:
            port_digest.CHUNK_SIZE = old
    base = ["query", "-dir", d, "-table", "uptime", "-int", "ping", "-json"]
    if "-group" not in argv:
        base += ["-group", "host"]
    if item in ("B9", "B10"):
        want = _cli_out(ref_cli.main, base + argv, capsys)
        assert _cli_out(port_cli.main, base + argv + ["-device", "cpu"],
                        capsys) == want
        if item == "B10":
            assert len(json.loads(want)) == 100      # the default -limit
        else:
            assert '"Distinct"' in want
        return
    assert port_cli.main(base + argv + ["-device", "cpu"]) == 2
    assert item in capsys.readouterr().err


@pytest.fixture(scope="module")
def wide_table(tmp_path_factory):
    """600 rows of 33 int columns c0..c32 and 17 group columns (g0..g8
    str, g9..g16 int), each of two or three values: the shapes past the
    kernels' former fixed caps."""
    d = str(tmp_path_factory.mktemp("widedb"))
    rng = np.random.default_rng(41)
    n = 600
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 256
    try:
        RefTable("wide", RefFlags(dir=d, table="wide",
                                  skip_compact=True)).ingest_columns(
            ints={**{f"c{i}": rng.integers(-50, 400, n) for i in range(33)},
                  **{f"g{i}": rng.integers(0, 3, n) for i in range(9, 17)}},
            strs={f"g{i}": [("a", "b")[j] for j in rng.integers(0, 2, n)]
                  for i in range(9)},
            valid={"c3": rng.random(n) > 0.1, "g2": rng.random(n) > 0.1})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("what,argv", [
    ("17 int filters", ["-group", "g0", "-int", "c0", "-int-filter",
                        ",".join(f"c{i}:gt:-40" for i in range(17))]),
    ("33 aggregations", ["-group", "g9", "-int",
                         ",".join(f"c{i}" for i in range(33))]),
    ("17 group columns", ["-group", ",".join(f"g{i}" for i in range(17)),
                          "-int", "c1,c2", "-op", "hist"]),
])
def test_past_former_kernel_caps_matches_reference(wide_table, what, argv,
                                                   fmt, capsys):
    """17 filters, 33 aggregations and 17 group columns: the kernels took
    at most 16, 32 and 16 before their argument arrays moved to a device
    buffer; the reference has no cap."""
    base = ["query", "-dir", wide_table, "-table", "wide", *argv]
    if fmt == "json":
        base.append("-json")
    want = _cli_out(ref_cli.main, base, capsys)
    assert want
    assert _cli_out(port_cli.main, base + ["-device", "cpu"], capsys) == want


def test_other_subcommands_are_not_ported(capsys):
    assert port_cli.main(["digest", "-dir", "x", "-table", "t"]) == 2
    assert "not ported yet" in capsys.readouterr().err
    assert port_cli.main(["version", "-json"]) == 0
    assert json.loads(capsys.readouterr().out)["engine"] == "torch-cuda"


def test_warm_query_reuses_resident_columns(ref_table):
    flags = Flags(dir=ref_table, table="uptime", device="cpu",
                  device_batch=16)
    t = Table("uptime", flags)
    params = QueryParams(groups=("host",), aggs=(AggDef("ping", "avg"),))
    residency.CACHE.clear()
    cold = run_query(t, params, flags)
    misses = residency.CACHE.misses
    warm = run_query(t, params, flags)
    assert residency.CACHE.misses == misses
    assert _snapshot(cold) == _snapshot(warm)
