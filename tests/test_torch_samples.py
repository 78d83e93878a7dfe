"""-samples in the port against the JAX reference, on the CPU.

Batch level: the matched mask (out["matched"], a bool [B, C]) of the
port's dense and sorted strategies (K2's and K7's plain versions) equals
the reference's on the same numpy batch: rows past nrec, filters, set
filters, a rollup whose rows lack the time column, a key that spills.
Query level: both engines' sample lists and printed bytes are equal, on
the dense and sorted strategies, with -sample-cols, with set filters and
across the dense-spill retry."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
from sybil_tpu import cli as ref_cli
from sybil_tpu import codec
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.digest import digest_records
from sybil_tpu.ingest import flatten_record
from sybil_tpu.ops import scan as ref
from sybil_tpu.query import engine as ref_engine
from sybil_tpu.query.spec import FilterDef as RefFilter
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import blocks as port_blocks
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query import engine as port_engine
from sybil_tpu_torch.query.spec import FilterDef, QueryParams
from sybil_tpu_torch.table import Table

B, C = 3, 1024
R = B * C

# name -> options: strategy (dense or sorted); time (a rollup over column
# t, present in 90% of rows, bucket 100); spill (a key bound one short of
# the values); filters (col, op, kind, constant; s0 a set column); nrec
MASK_CASES = {
    "dense": dict(),
    "dense-partial-filters": dict(nrec=(0, 700, 1),
                                  filters=[("fi", "gt", "int", 20),
                                           ("fs", "re", "str", 0)]),
    "dense-rollup-missing-time": dict(time=True),
    "dense-spilled-key": dict(spill=True),
    "dense-set-filter": dict(filters=[("s0", "nin", "set", 2)]),
    "sorted": dict(strategy="sorted", filters=[("fi", "lt", "int", 50)]),
    "sorted-rollup-missing-time": dict(strategy="sorted", time=True),
    "sorted-set-filter": dict(strategy="sorted", nrec=(C, 0, 9),
                              filters=[("s0", "in", "set", 5)]),
}


def make_mask_case(name):
    o = MASK_CASES[name]
    rng = np.random.default_rng(900 + sorted(MASK_CASES).index(name))
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    put("k0", rng.integers(0, 6, R), 0.9)
    put("v0", rng.integers(0, 100, R), 0.85)
    bounds = [(0, 5 if o.get("spill") else 6)]
    kw = {}
    if o.get("time"):
        put("t", rng.integers(0, 5000, R), 0.9)
        bounds.insert(0, (0, 50))
        kw["time_col"] = "t"
    filters, fvals = [], []
    ref_aux, port_aux = {}, {}
    for col, op, kind, val in o.get("filters", ()):
        if kind == "set":
            lists = [[int(x) for x in rng.integers(0, 8, rng.integers(0, 3))]
                     for _ in range(R)]
            rows = np.repeat(np.arange(R), [len(x) for x in lists])
            vals = np.asarray([v for x in lists for v in x], np.int64)
            prow, pval = port_engine.pad_set_csr(rows, vals, R)
            ref_aux[col] = (jnp.asarray(prow), jnp.asarray(pval))
            port_aux[col] = (torch.from_numpy(prow), torch.from_numpy(pval),
                             len(rows))
        elif col not in cols:
            put(col, rng.integers(0, 80 if col == "fi" else 10, R), 0.9)
        filters.append(ref.FilterSpec(col, op, kind,
                                      0 if op in ("re", "nre") else -1))
        fvals.append(val)
    if o.get("strategy") == "sorted":
        kw["force_sorted"] = True
    cfg = ref.ScanConfig(
        group_cols=("k0",), filters=tuple(filters),
        aggs=(ref.AggSpec("v0", hist_min=0, bucket_size=0, num_values=0,
                          discard_min=0, discard_max=100),),
        key_bounds=tuple(bounds), want_matched_mask=True, **kw)
    nrec = np.array(o.get("nrec", (C, C - 300, C - 3)), np.int32)
    return cfg, cols, nrec, np.asarray(fvals, np.int64), ref_aux, port_aux


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_matched_mask_matches_reference(name):
    cfg, cols, nrec, fvals, ref_aux, port_aux = make_mask_case(name)
    bits = (np.array([i % 3 != 0 for i in range(10)]),)
    tb = 100
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(tb, jnp.int64),
        ref_aux)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    assert pcfg.strategy == MASK_CASES[name].get("strategy", "dense")
    assert port.enum_radix(dataclasses.replace(
        pcfg, sort_pack=pcfg.key_bounds, prune_topk=10)) == 0
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), tuple(torch.from_numpy(b) for b in bits),
        tb, port_aux)
    want = np.asarray(out["matched"])
    got = raw["matched"].numpy()
    assert got.dtype == np.bool_ and got.shape == (B, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ppacked["main"].numpy(),
                                  np.asarray(packed["main"]))
    assert 0 < int(want.sum()) <= int(nrec.sum())
    if name == "dense-spilled-key":
        # a matched row whose key spilled is still matched
        assert int(np.asarray(packed["main"])[0, 1]) > 0
        k, km = cols["k0"]
        assert want[(k == 5) & km].any()
    if "missing-time" in name:
        assert not want[~cols["t"][1]].any()


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]


def _ingest(table, chunk, steps):
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = chunk
    try:
        for ints, strs, sets, valid in steps:
            table.ingest_columns(ints=ints, strs=strs, sets=sets,
                                 valid=valid)
    finally:
        ref_digest.CHUNK_SIZE = old


@pytest.fixture(scope="module")
def uptime(tmp_path_factory):
    """1,800 uptime rows in 512-row blocks, missing hosts and pings, a
    `groups` set of mod2 / mod3 / mod5 of index_int, or none."""
    d = str(tmp_path_factory.mktemp("upsamples"))
    rng = np.random.default_rng(1337)
    n = 1800
    idx = np.arange(n, dtype=np.int64)
    _ingest(RefTable("uptime", RefFlags(dir=d, table="uptime",
                                        skip_compact=True)), 512, [(
        {"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
         "weight": rng.choice([1, 10, 100], n).astype(np.int64),
         "index_int": idx},
        {"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
         "status": [STATII[i] for i in rng.integers(0, 5, n)]},
        {"groups": [[g for m, g in ((2, "mod2"), (3, "mod3"), (5, "mod5"))
                     if i % m == 0] or ["none"] for i in idx.tolist()]},
        {"host": rng.random(n) > 0.05, "ping": rng.random(n) > 0.1})])
    return d


def cli_out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["text", "-json"])
@pytest.mark.parametrize("argv", [
    ["-samples", "-limit", "7"],
    ["-samples", "-limit", "10", "-set-filter", "groups:in:mod3"],
    ["-samples", "-limit", "10", "-sample-cols", "host,ping,groups",
     "-group", "host", "-int", "ping", "-op", "hist", "-tdigest"],
    ["-samples", "-limit", "4", "-str-filter", "status:eq:200",
     "-int-filter", "ping:gt:70", "-set-filter", "groups:nin:mod2",
     "-device-batch", "1"],
    ["-samples", "-limit", "3", "-set-filter", "groups:in:nosuch"],
], ids=["S4-limit-7", "S4a", "S4b-sorted", "filters-per-block-batches",
        "no-match"])
def test_samples_cli_bytes_match_reference(uptime, argv, fmt, capsys):
    """tests/test_cli.py:112 (-samples -limit 7 -json), and chip_smoke's
    S4a and S4b shapes."""
    base = ["query", "-dir", uptime, "-table", "uptime", *argv]
    if fmt == "-json":
        base.append("-json")
    want = cli_out(ref_cli.main, base, capsys)
    assert cli_out(port_cli.main, base + ["-device", "cpu"], capsys) == want
    if fmt == "-json":
        rows = json.loads(want)
        limit = int(argv[argv.index("-limit") + 1])
        assert len(rows) == (0 if "nosuch" in argv[-1] else limit)
        if "-sample-cols" in argv:
            assert all(set(r) <= {"host", "ping", "groups"} for r in rows)


def samples_both(d, table, batch=16, filters=(), **kw):
    """Both engines' samples of one query, held equal."""
    want = ref_engine.run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        RefParams(samples=True, filters=tuple(RefFilter(*f) for f in filters),
                  **kw), RefFlags(dir=d, table=table, device_batch=batch))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=batch)
    got = port_engine.run_query(
        Table(table, flags),
        QueryParams(samples=True, filters=tuple(FilterDef(*f)
                                                for f in filters), **kw),
        flags)
    assert got.samples == want.samples
    assert got.matched_count == want.matched_count
    return got.samples


def test_sample_cols(tmp_path):
    """tests/test_query_features.py:145: -sample-cols loads only the
    columns asked for."""
    d = str(tmp_path)
    t = RefTable("t", RefFlags(dir=d, table="t", skip_compact=True))
    t.ingest_records([flatten_record({"host": f"h{i % 3}", "ping": i,
                                      "extra": i * 2, "time": i})
                      for i in range(100)])
    digest_records(t)
    rows = samples_both(d, "t", limit=5)
    assert len(rows) == 20 and any("extra" in s for s in rows)
    rows = samples_both(d, "t", limit=5, sample_cols=("host", "ping"))
    assert rows and all(set(s) <= {"host", "ping"} for s in rows)


@pytest.mark.parametrize("op", ["in", "nin"])
def test_samples_with_set_filter(tmp_path, op):
    """tests/test_query_features.py:623: samples honour set filters."""
    d = str(tmp_path)
    t = RefTable("t", RefFlags(dir=d, table="t", skip_compact=True))
    t.ingest_records([flatten_record(
        {"uid": i, "groups": [f"g{i % 3}", "all"], "v": i})
        for i in range(500)])
    digest_records(t)
    rows = samples_both(d, "t", limit=5,
                        filters=(("groups", op, "g2", "set"),))
    assert len(rows) == 20
    assert all(("g2" in s["groups"]) == (op == "in") for s in rows)
    assert all((s["uid"] % 3 == 2) == (op == "in") for s in rows)


def test_samples_in_block_order_from_the_blocks(uptime):
    """The samples are the first matched rows in block order, each row
    as the blocks hold it (the port's blocks module reads them back)."""
    rows = samples_both(uptime, "uptime", batch=2, limit=6,
                        filters=(("groups", "in", "mod5", "set"),
                                 ("ping", "gt", "50", "int")))
    t = Table("uptime", Flags(dir=uptime, table="uptime"))
    t.load_info()
    want = []
    for bdir in t.block_infos():          # the engine's scan order
        data = port_blocks.load_block_columns(bdir, t.schema,
                                              ["index_int", "ping"])
        for i, p, ok in zip(data["index_int"].values, data["ping"].values,
                            data["ping"].valid):
            if i % 5 == 0 and ok and p > 50:
                want.append(int(i))
    assert [s["index_int"] for s in rows] == want[:24]


def spill_table(d: str):
    """tests/test_torch_sorted.py's spill table: an int group key whose
    table IntInfo ignores one outlier value, with the first block's exact
    bounds removed, so the dense scan spills and the engine retries on
    the sorted strategy."""
    rng = np.random.default_rng(77)
    n = 2048
    g = rng.integers(0, 20, n).astype(np.int64)
    g[1500] = 1_000_000
    t = RefTable("spill", RefFlags(dir=d, table="spill", skip_compact=True))
    _ingest(t, 512, [({"g": g, "v": rng.integers(0, 100, n)
                       .astype(np.int64)}, {}, {}, {})])
    blocks = sorted(b for b in os.listdir(os.path.join(d, "spill"))
                    if b.startswith("block"))
    info = os.path.join(d, "spill", blocks[0], "info.json")
    meta = codec.read_json(info)
    meta["int_exact"] = {}
    codec.write_json_atomic(info, meta)
    return d


@pytest.mark.parametrize("limit", [3, 200])
def test_samples_across_the_dense_spill_retry(tmp_path, limit, monkeypatch):
    """The spilled scan restarts with a fresh accumulator: the samples come
    from the sorted strategy's mask, as the reference's do."""
    d = spill_table(str(tmp_path))
    seen = []
    real = port.scan_packed

    def spy(cfg, *a, **k):
        seen.append(cfg.strategy)
        return real(cfg, *a, **k)

    monkeypatch.setattr(port, "scan_packed", spy)
    rows = samples_both(d, "spill", batch=2, limit=limit, groups=("g",),
                        filters=(("v", "lt", "50", "int"),))
    assert seen == ["dense", "dense", "sorted", "sorted"]
    assert len(rows) == limit * 4
    assert all(s["v"] < 50 for s in rows)
