"""The row store in the port against the JAX reference, on the CPU:
-read-log over the undigested WAL tail, ingest and digest.

Batch level: K3's keyed form of a pseudo-block's own table (B1, the
row-store scan's no_compact_table pack) through the port's scan_packed
against sybil_tpu's scan_packed_jit on the same seeded [1, C] block, the
packed download word for word.  Query level: a table digested by the
reference with a WAL tail on top (strings and int keys found only in the
WAL, values past the blocks' bounds, a set column) is queried through
both CLIs with -read-log, text and -json byte for byte; an empty WAL, a
corrupt and an uncompressed log, -read-log beside -cache-queries (the
cache is skipped) and beside -data-shards 2.  Mirrors of the reference's
tests/test_cache_readlog.py:22-68 and 233-277 run on the port, and the
two packages' digests write the same block and dictionary bytes.

Tolerance 0 everywhere (packed words, printed bytes, block files)."""

import contextlib
import dataclasses
import gzip
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
import sybil_tpu_torch.digest as port_digest
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.ingest import flatten_record as ref_flatten
from sybil_tpu.ops import scan as ref
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch import rowstore
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.digest import digest_records
from sybil_tpu_torch.ingest import flatten_record
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query import engine as port_engine
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
from sybil_tpu_torch.table import Table

# ---------------------------------------------------------------------------
# batch level: B1, the keyed table of a pseudo-block's own scan
# ---------------------------------------------------------------------------

C = 2048
TB = 100
HIST = dict(hist_min=0, bucket_size=10, num_values=8, discard_min=0,
            discard_max=1000)
AVG = dict(hist_min=0, bucket_size=1, num_values=0, discard_min=-10 ** 9,
           discard_max=10 ** 9)

# name -> ScanConfig fields (no_compact_table added): "k" a key with
# MISSING rows and negative values, "u" and "n" more keys, "t" a time
# column (quotients -4..29 at TB), "v" a value past a hist's range, "w" a
# weight, "__count__" the pseudo-block's column without any other
B1_CASES = {
    "one key, MISSING and negative": dict(
        group_cols=("k",), aggs=(("v", AVG),), key_bounds=((-3, 7),)),
    "three keys": dict(
        group_cols=("k", "u", "n"), aggs=(("v", AVG),),
        key_bounds=((-3, 7), (0, 9), (-5, 4))),
    "time key, digit 0 at min - 1": dict(
        group_cols=("k",), aggs=(("v", AVG),), time_col="t",
        key_bounds=((-3, 30), (-3, 7))),
    "no group-by (__count__)": dict(group_cols=(), aggs=()),
    "compact reduce space": dict(
        group_cols=("u",), aggs=(("v", AVG),), key_bounds=((0, 9),)),
    "reduce space = slots (no compaction)": dict(
        group_cols=("u",), aggs=(("v", AVG),), key_bounds=((0, 126),)),
    "hist with outliers beside avg": dict(
        group_cols=("k",), aggs=(("v", HIST), ("w", AVG)),
        key_bounds=((-3, 7),), track_outliers=True),
    "device HLL": dict(group_cols=("k",), distinct_cols=("u",), hll=True,
                       key_bounds=((-3, 7),)),
    "weight column": dict(group_cols=("k",), aggs=(("v", AVG),),
                          weight_col="w", key_bounds=((-3, 7),)),
}


def b1_batch(name):
    rng = np.random.default_rng(sum(map(ord, name)))

    def col(v, p):
        return (np.asarray(v, np.int64).reshape(1, C),
                (rng.random(C) < p).reshape(1, C))
    cols = {"k": col(rng.integers(-3, 4, C), 0.9),
            "u": col(rng.integers(0, 9, C), 0.95),
            "n": col(rng.integers(-5, -1, C), 0.9),
            "t": col(rng.integers(-400, 3000, C), 0.95),
            "v": col(rng.integers(0, 200, C), 0.9),
            "w": col(rng.choice([0, 1, 10, 100], C), 0.9)}
    if name == "no group-by (__count__)":
        cols = {"__count__": (np.zeros((1, C), np.int64),
                              np.ones((1, C), bool))}
    return cols, np.array([C - 48], np.int32)


def b1_config(name):
    o = dict(B1_CASES[name])
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o.get("aggs", ()))
    return ref.ScanConfig(filters=(), no_compact_table=True, **o)


@pytest.mark.parametrize("name", list(B1_CASES))
def test_keyed_table_of_a_pseudo_block_matches_reference(name):
    cfg = b1_config(name)
    assert cfg.strategy == "dense" and ref.dense_table_plan(cfg, C) is None
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    cols, nrec = b1_batch(name)
    want, _ = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.zeros(0, jnp.int64), (),
        jnp.asarray(TB, jnp.int64), {})
    got, _ = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()},
        torch.from_numpy(nrec), torch.zeros(0, dtype=torch.int64), (), TB,
        {})
    np.testing.assert_array_equal(got["main"].numpy(),
                                  np.asarray(want["main"]))
    # the table's key columns are the slots' decoded keys
    K = pcfg.n_key_cols
    keys = got["main"].numpy()[1:1 + pcfg.dense_slots, :K]
    np.testing.assert_array_equal(keys, port.dense_keys_np(pcfg, TB))


def test_keyed_form_is_its_own_counted_entry():
    """The keyed form of a scan's own table launches through the
    dense_keyed entry of dense_pack.cu and is counted under that name."""
    from sybil_tpu_torch.ops import kernels
    assert kernels.ENTRY_SOURCES["dense_keyed"] == "dense_pack"
    assert "dense_keyed" in kernels.LAUNCHES
    pcfg = port.config_from_fields(dataclasses.asdict(
        b1_config("one key, MISSING and negative")))
    assert port._pack_form(pcfg, {}) == "keyed"
    assert port._pack_form(dataclasses.replace(
        pcfg, no_compact_table=False), {}) == "compact"
    with pytest.raises(ValueError, match="needs no_compact_table"):
        port._pack_form(dataclasses.replace(pcfg, no_compact_table=False),
                        {"keys": None})


# ---------------------------------------------------------------------------
# query level: -read-log through both CLIs
# ---------------------------------------------------------------------------

HOSTS = ["a.com", "b.com", "c.com"]
CHUNK = 512


def _records(n, seed, start=0, tail=False):
    """Uptime-like records; the tail adds a host and a status only in the
    WAL, pings past the blocks' max, a code past the blocks' bound, and
    rows without ping."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = {"host": HOSTS[int(rng.integers(0, 3))],
             "status": str(int(rng.choice([200, 404]))),
             "ping": int(rng.integers(0, 100)),
             "code": int(rng.integers(0, 6)),
             "time": 1_700_000_000 + 60 * (start + i)}
        if i % 4 == 0:
            r["tags"] = [f"t{i % 3}", f"t{i % 2}"]
        if tail:
            if i % 9 == 0:
                r["host"] = "wal-only.com"
            if i % 11 == 0:
                r["status"] = "wal"
            if i % 13 == 0:
                r["ping"] = 100 + i % 300
            if i % 17 == 0:
                r["code"] = 40 + i % 5
            if i % 19 == 0:
                del r["ping"]
        out.append(r)
    return out


def _build(d, n=2600, tail=700):
    """Digested blocks of CHUNK rows (the reference's digest) and an
    undigested WAL tail, through the reference's ingest."""
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = CHUNK
    try:
        t = RefTable("up", RefFlags(dir=d, table="up", skip_compact=True))
        t.ingest_records([ref_flatten(r) for r in _records(n, 1)])
        ref_digest.digest_records(t)
        if tail:
            half = tail // 2
            recs = _records(tail, 2, start=n, tail=True)
            t.ingest_records([ref_flatten(r) for r in recs[:half]])
            t.ingest_records([ref_flatten(r) for r in recs[half:]])
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


@pytest.fixture(scope="module")
def wal_table(tmp_path_factory):
    return _build(str(tmp_path_factory.mktemp("rowstore")))


def _cli_out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None), argv
    return buf.getvalue()


def _both(d, argv, table="up"):
    base = ["query", "-dir", d, "-table", table, "-read-log", *argv]
    want = _cli_out(ref_cli.main, base)
    got = _cli_out(port_cli.main, base + ["-device", "cpu"])
    return want, got


QUERIES = {
    "group avg": ["-group", "host", "-int", "ping", "-op", "avg"],
    "hist -loghist": ["-group", "host", "-int", "ping", "-op", "hist",
                      "-loghist"],
    # the WAL's times lie past the blocks' time bound: the sorted retry
    "time rollup, sorted retry": ["-group", "host", "-int", "ping", "-time",
                                  "-time-bucket", "3600", "-time-col",
                                  "time"],
    "tdigest (sorted)": ["-group", "host", "-int", "ping", "-op", "hist",
                         "-tdigest"],
    "set filter": ["-group", "host", "-int", "ping", "-set-filter",
                   "tags:in:t1"],
    "distinct": ["-group", "host", "-distinct", "code"],
    "WAL-only strings": ["-group", "host,status", "-int", "ping",
                         "-str-filter", "status:neq:404"],
    "int key past the blocks' bound (sorted retry)": [
        "-group", "code", "-int", "ping"],
    "cache-queries skipped": ["-group", "host", "-int", "ping",
                              "-cache-queries"],
    "data-shards 2": ["-group", "host", "-int", "ping", "-data-shards", "2"],
}


@pytest.mark.parametrize("mode", ["text", "json"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_read_log_query_matches_reference(wal_table, name, mode):
    argv = QUERIES[name] + (["-json"] if mode == "json" else [])
    retries = port_engine.ROWSTORE["sorted_retries"]
    want, got = _both(wal_table, argv)
    assert want and got == want
    took = port_engine.ROWSTORE["sorted_retries"] - retries
    assert took > 0 if "retry" in name else True
    if name == "cache-queries skipped":
        assert not os.path.exists(os.path.join(wal_table, "up", "cache")) \
            or not [f for f in os.listdir(os.path.join(wal_table, "up",
                                                        "cache"))
                    if f.startswith("q_")]


def test_empty_wal_is_the_digested_answer(tmp_path):
    d = _build(str(tmp_path), n=1500, tail=0)
    argv = ["-group", "host", "-int", "ping", "-json"]
    want, got = _both(d, argv)
    assert got == want
    assert got == _cli_out(port_cli.main, ["query", "-dir", d, "-table",
                                           "up", *argv, "-device", "cpu"])


def test_corrupt_and_uncompressed_logs(tmp_path):
    """A truncated .wal.gz is skipped with a warning and a plain .wal log
    is read, by the reference and the port alike (the per-file fallback
    to the row decoder included)."""
    d = _build(str(tmp_path), n=1500, tail=300)
    logs = rowstore.list_logs(os.path.join(d, "up"))
    with gzip.open(logs[0], "rb") as f:
        raw = f.read()
    with open(logs[0][:-3], "wb") as f:       # the same records, plain
        f.write(raw)
    os.remove(logs[0])
    with open(logs[1], "rb") as f:
        blob = f.read()
    with open(logs[1], "wb") as f:            # truncated gzip
        f.write(blob[: len(blob) // 2])
    for argv in (["-group", "host", "-int", "ping", "-json"],
                 ["-group", "host", "-int", "ping", "-op", "hist"]):
        want, got = _both(d, argv)
        assert want and got == want


# ---------------------------------------------------------------------------
# mirrors of tests/test_cache_readlog.py on the port
# ---------------------------------------------------------------------------

def _make(tmp_path, n=300):
    flags = Flags(dir=str(tmp_path / "db"), table="t", skip_compact=True,
                  device="cpu")
    t = Table("t", flags)
    t.ingest_records([flatten_record({"x": i % 7, "v": i})
                      for i in range(n)])
    return t, flags


def test_read_log_scans_undigested(tmp_path):
    t, flags = _make(tmp_path)
    params = QueryParams(groups=("x",), aggs=(AggDef("v", "avg"),))
    qr = run_query(t, params, flags)
    assert sum(r.count for r in qr.results.values()) == 0
    rl_flags = dataclasses.replace(flags, read_log=True)
    qr = run_query(t, params, rl_flags)
    assert sum(r.count for r in qr.results.values()) == 300
    assert len(qr.results) == 7
    digest_records(t)
    t.ingest_records([flatten_record({"x": 1, "v": 5}) for _ in range(10)])
    qr = run_query(t, params, rl_flags)
    assert sum(r.count for r in qr.results.values()) == 310


def test_read_log_with_filter(tmp_path):
    t, flags = _make(tmp_path)
    rl_flags = dataclasses.replace(flags, read_log=True)
    params = QueryParams(groups=("x",),
                         filters=(FilterDef("v", "lt", "100", "int"),))
    qr = run_query(t, params, rl_flags)
    assert sum(r.count for r in qr.results.values()) == 100


def test_read_log_values_outside_block_bounds(tmp_path):
    """WAL rows past the digested blocks' exact statistics (limb widths,
    value biases, lanes proven equal to samples): the pseudo-block scan
    strips those specialisations, so the sums stay exact."""
    flags = Flags(dir=str(tmp_path / "db"), table="wb", skip_compact=True,
                  device="cpu")
    t = Table("wb", flags)
    t.ingest_records([flatten_record({"g": f"k{i % 3}", "v": i % 10,
                                      "time": i}) for i in range(300)])
    digest_records(t)
    t.ingest_records([flatten_record({"g": "k0", "v": 89, "time": 1000}),
                      flatten_record({"g": "k1", "v": 57, "time": 1001}),
                      flatten_record({"g": "k2", "time": 1002})])
    rl = dataclasses.replace(flags, read_log=True)
    qr = run_query(t, QueryParams(groups=("g",), aggs=(AggDef("v", "avg"),)),
                   rl)
    got = {r.group_key.rstrip("\t"): (r.count, r.hists["v"].mean())
           for r in qr.results.values()}
    sums = {k: [0, 0] for k in ("k0", "k1", "k2")}
    for i in range(300):
        sums[f"k{i % 3}"][0] += i % 10
        sums[f"k{i % 3}"][1] += 1
    sums["k0"][0] += 89
    sums["k0"][1] += 1
    sums["k1"][0] += 57
    sums["k1"][1] += 1
    assert got["k0"][0] == 101 and got["k1"][0] == 101
    assert got["k2"][0] == 101
    for k in ("k0", "k1", "k2"):
        assert got[k][1] == sums[k][0] / sums[k][1]


# ---------------------------------------------------------------------------
# digest parity: the two packages write the same files
# ---------------------------------------------------------------------------

def _tree(d):
    """{relative path: bytes} of a table's blocks (in name order, as
    block0, block1, ...: names carry a time and a uuid) and dictionaries."""
    out = {}
    blocks = sorted(b for b in os.listdir(d) if b.startswith("block"))
    for i, b in enumerate(blocks):
        for f in sorted(os.listdir(os.path.join(d, b))):
            with open(os.path.join(d, b, f), "rb") as fh:
                out[f"block{i}/{f}"] = fh.read()
    for root, _, files in os.walk(d):
        rel = os.path.relpath(root, d)
        if rel.split(os.sep)[0] in ("dicts", "dict"):
            for f in files:
                with open(os.path.join(root, f), "rb") as fh:
                    out[os.path.join(rel, f)] = fh.read()
    return out


def test_digest_writes_the_reference_bytes(tmp_path):
    recs = _records(1400, 5, tail=True)
    dirs = {}
    old = (ref_digest.CHUNK_SIZE, port_digest.CHUNK_SIZE)
    ref_digest.CHUNK_SIZE = port_digest.CHUNK_SIZE = CHUNK
    try:
        for tag, table_cls, flags_cls, flatten, digest in (
                ("ref", RefTable, RefFlags, ref_flatten,
                 ref_digest.digest_records),
                ("port", Table, Flags, flatten_record, digest_records)):
            d = str(tmp_path / tag)
            t = table_cls("up", flags_cls(dir=d, table="up",
                                          skip_compact=True))
            # two digests: the second tops up the first's partial block
            for lo, hi in ((0, 900), (900, 1400)):
                t.ingest_records([flatten(r) for r in recs[lo:hi]])
                digest(t)
            assert not rowstore.list_logs(os.path.join(d, "up"))
            dirs[tag] = d
    finally:
        ref_digest.CHUNK_SIZE, port_digest.CHUNK_SIZE = old
    ref_tree = _tree(os.path.join(dirs["ref"], "up"))
    port_tree = _tree(os.path.join(dirs["port"], "up"))
    assert any(k.startswith("block2/") for k in ref_tree)
    assert any(not k.startswith("block") for k in ref_tree)
    assert set(port_tree) == set(ref_tree)
    for k in ref_tree:
        assert port_tree[k] == ref_tree[k], k
    # each package reads the other's table
    argv = ["-table", "up", "-group", "host,status", "-int", "ping", "-op",
            "hist", "-json"]
    outs = [_cli_out(ref_cli.main, ["query", "-dir", d, *argv])
            for d in (dirs["ref"], dirs["port"])]
    outs += [_cli_out(port_cli.main, ["query", "-dir", d, *argv, "-device",
                                      "cpu"])
             for d in (dirs["ref"], dirs["port"])]
    assert outs[0] and all(o == outs[0] for o in outs)


# ---------------------------------------------------------------------------
# mirrors of tests/test_native.py:37-99 on the port's own native copy
# ---------------------------------------------------------------------------

@pytest.fixture
def port_native():
    from sybil_tpu_torch import native
    if not native.available():
        pytest.skip("g++ could not build the port's native WAL decoder")
    return native


def _native_records(n=500, seed=7):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(int(n)):
        rec = {"age": int(rng.integers(0, 90)),
               "name": f"user_{int(rng.integers(0, 40))}",
               "time": 1_700_000_000 + int(rng.integers(0, 10_000))}
        if i % 3 == 0:
            rec["groups"] = [f"g{i % 2}", f"g{i % 5}"]
        if i % 7 == 0:
            del rec["age"]
        if i % 11 == 0:
            rec["note"] = 'uni"code\né東'
        recs.append(flatten_record(rec))
    return recs


def test_columnar_replay_matches_row_pivot(port_native, tmp_path):
    from sybil_tpu_torch.blocks import (IntColumnData, SetColumnData,
                                        StrColumnData)
    from sybil_tpu_torch.columnar import parse_log_columnar
    from sybil_tpu_torch.digest import rows_to_columns
    t = Table("t", Flags(dir=str(tmp_path / "db"), table="t"))
    recs = _native_records()
    t.ingest_records(recs)
    log = rowstore.list_logs(t.dir)[0]
    cols_n, n_native = parse_log_columnar(log, t)
    assert n_native == len(recs)
    cols_py = rows_to_columns(rowstore.read_log(log), t)
    assert set(cols_n) == set(cols_py)
    for name in cols_py:
        a, b = cols_n[name], cols_py[name]
        if isinstance(b, IntColumnData):
            np.testing.assert_array_equal(a.valid, b.valid)
            np.testing.assert_array_equal(a.values[a.valid],
                                          b.values[b.valid])
        elif isinstance(b, StrColumnData):
            np.testing.assert_array_equal(a.valid, b.valid)
            strs = t.dicts.get(name).strings
            assert [strs[i] for i in a.ids[a.valid]] == \
                   [strs[i] for i in b.ids[b.valid]]
        else:
            assert isinstance(b, SetColumnData)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            strs = t.dicts.get(name).strings
            assert [strs[i] for i in a.values] == [strs[i] for i in b.values]


def test_native_digest_query_parity(port_native, tmp_path, monkeypatch):
    def ingest_digest(flags):
        t = Table("t", flags)
        t.ingest_records(_native_records(800))
        digest_records(t)
        return t
    qp = QueryParams(groups=("name",), aggs=(AggDef("age", "avg"),))
    f_native = Flags(dir=str(tmp_path / "db"), table="t", device="cpu")
    r_native = run_query(ingest_digest(f_native), qp, f_native)
    f_py = Flags(dir=str(tmp_path / "db_py"), table="t", device="cpu")
    monkeypatch.setattr(port_native, "_mod", None)   # the Python fallback
    r_py = run_query(ingest_digest(f_py), qp, f_py)
    assert set(r_native.results) == set(r_py.results)
    for k, res in r_py.results.items():
        got = r_native.results[k]
        assert got.count == res.count
        assert got.hists["age"].mean() == res.hists["age"].mean()


def test_malformed_wal_falls_back(port_native):
    assert port_native.parse_wal_bytes(b'{"i": {"a": 1.5}}\n') is None
    assert port_native.parse_wal_bytes(b'{"unknown": 1}\n') is None
    assert port_native.parse_wal_bytes(b"not json\n") is None


def test_escapes_and_big_ints(port_native):
    recs = [{"s": {"x": "a\tb\\c€\U0001F600"}},
            {"i": {"v": -(2**63), "w": 2**63 - 1}}]
    data = ("\n".join(json.dumps(r, separators=(",", ":"))
                      for r in recs) + "\n").encode()
    out = port_native.parse_wal_bytes(data)
    assert out is not None
    blob, offs = out["strs"]["x"][2]
    offs = np.frombuffer(offs, np.uint32)
    assert blob[offs[0]:offs[1]].decode() == "a\tb\\c€\U0001F600"
    assert np.frombuffer(out["ints"]["v"][0], np.int64)[1] == -(2**63)
    assert np.frombuffer(out["ints"]["w"][0], np.int64)[1] == 2**63 - 1
    assert port_native.parse_wal_bytes(
        b'{"i": {"v": 9223372036854775808}}\n') is None


# ---------------------------------------------------------------------------
# mirrors of tests/test_bulk_ingest.py on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def small_chunk(monkeypatch):
    from sybil_tpu_torch import constants
    monkeypatch.setattr(constants, "CHUNK_SIZE", 100)
    monkeypatch.setattr(port_digest, "CHUNK_SIZE", 100)


def test_bulk_matches_wal_digest(small_chunk, tmp_path):
    rng = np.random.default_rng(3)
    n = 450
    ks = [f"k{i}" for i in rng.integers(0, 4, n)]
    vs = rng.integers(0, 1000, n).astype(np.int64)
    miss = rng.random(n) > 0.1
    tags = [[f"t{i % 2}", f"t{i % 3}"] if i % 4 == 0 else []
            for i in range(n)]
    f_bulk = Flags(dir=str(tmp_path / "bulk"), table="t", device="cpu")
    t_bulk = Table("t", f_bulk)
    assert t_bulk.ingest_columns(
        ints={"v": vs, "time": np.arange(n)}, strs={"k": ks},
        sets={"tags": tags}, valid={"v": miss}) == 5
    f_wal = Flags(dir=str(tmp_path / "wal"), table="t", device="cpu")
    t_wal = Table("t", f_wal)
    recs = []
    for i in range(n):
        r = {"k": ks[i], "time": i}
        if miss[i]:
            r["v"] = int(vs[i])
        if tags[i]:
            r["tags"] = tags[i]
        recs.append(flatten_record(r))
    t_wal.ingest_records(recs)
    digest_records(t_wal)
    qp = QueryParams(groups=("k",), aggs=(AggDef("v", "avg"),))
    r_bulk, r_wal = run_query(t_bulk, qp, f_bulk), run_query(t_wal, qp, f_wal)
    assert set(r_bulk.results) == set(r_wal.results)
    for key, res in r_wal.results.items():
        got = r_bulk.results[key]
        assert got.count == res.count
        assert got.hists["v"].mean() == res.hists["v"].mean()
    qp2 = QueryParams(groups=("k",),
                      filters=(FilterDef("tags", "in", "t1", "set"),))
    assert {k: r.count for k, r in run_query(t_bulk, qp2, f_bulk)
            .results.items()} == \
        {k: r.count for k, r in run_query(t_wal, qp2, f_wal).results.items()}


def test_bulk_appends_to_partial(small_chunk, tmp_path):
    t = Table("t", Flags(dir=str(tmp_path / "db"), table="t"))
    t.ingest_columns(ints={"v": np.arange(130)})
    assert t.record_count() == 130
    t.ingest_columns(ints={"v": np.arange(50)})
    assert t.record_count() == 180
    assert sorted(i.num_records for i in t.block_infos().values()) == \
        [80, 100]


def test_bulk_length_mismatch(tmp_path):
    t = Table("t", Flags(dir=str(tmp_path / "db"), table="t"))
    with pytest.raises(ValueError):
        t.ingest_columns(ints={"a": np.arange(3)}, strs={"b": ["x"] * 4})


# ---------------------------------------------------------------------------
# mirrors of tests/test_cli.py's streaming ingest and yaml template
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_streaming_ingest_constant_memory(tmp_path):
    """The port's CLI ingest flushes every CHUNK_SIZE records inside the
    parse loop: its peak resident set stays far below what buffering the
    whole stream would take, and every record reaches the row store."""
    import subprocess
    import sys
    import time
    d = str(tmp_path / "db")
    env = dict(os.environ, PYTHONPATH=REPO, MALLOC_ARENA_MAX="2")
    feeder = (
        "import json,sys\n"
        "for i in range(340000):\n"
        "    sys.stdout.write(json.dumps({'h': 'host%d' % (i % 50),"
        " 'v': i % 997, 'pad': 'x' * 64, 'time': 1700000000 + i}) + '\\n')\n"
    )
    gen = subprocess.Popen([sys.executable, "-c", feeder],
                           stdout=subprocess.PIPE)
    ing = subprocess.Popen(
        [sys.executable, "-m", "sybil_tpu_torch", "ingest", "-dir", d,
         "-table", "s", "-skip-compact"],
        stdin=gen.stdout, stderr=subprocess.PIPE, cwd=REPO, env=env)
    gen.stdout.close()
    peak_kb = 0
    while ing.poll() is None:
        try:
            with open(f"/proc/{ing.pid}/status") as f:
                for ln in f:
                    if ln.startswith("VmHWM"):
                        peak_kb = max(peak_kb, int(ln.split()[1]))
        except OSError:
            pass
        time.sleep(0.05)
    gen.wait()
    assert ing.returncode == 0, ing.stderr.read()[-2000:].decode()
    assert 0 < peak_kb / 1024 < 480, f"ingest peaked at {peak_kb / 1024} MB"
    t = Table("s", Flags(dir=d, table="s"))
    logs = rowstore.list_logs(t.dir)
    assert len(logs) == 6                    # five full chunks and a tail
    assert sum(len(rowstore.read_log(f)) for f in logs) == 340000


def test_yaml_template_generator_ingest(tmp_path):
    import subprocess
    import sys
    gen = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts/fakedata/from_yaml.py"),
         os.path.join(REPO, "scripts/plait/host_generator.yaml"), "50",
         "--seed", "7"], capture_output=True, text=True, check=True)
    lines = gen.stdout.strip().splitlines()
    assert len(lines) == 50
    assert {"status", "host", "ping", "weight", "time"} <= \
        set(json.loads(lines[0]))
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-m", "sybil_tpu_torch", "ingest", "-dir",
         str(tmp_path), "-table", "yamlgen"],
        input=gen.stdout, capture_output=True, text=True, check=True,
        env=env)
    q = subprocess.run(
        [sys.executable, "-m", "sybil_tpu_torch", "query", "-dir",
         str(tmp_path), "-table", "yamlgen", "-read-log", "-json",
         "-device", "cpu"],
        capture_output=True, text=True, check=True, env=env)
    assert sum(r["Count"] for r in json.loads(q.stdout)) == 50
