"""The query cache (-cache-queries) in the port against the JAX reference,
on the CPU.

Batch level: hand-built cache-group configs ("__cg__" with vg_span > 0, in
both key layouts: [cg, *groups] and, under a time rollup, [cg, time,
*groups]) go through sybil_tpu.ops.scan.scan_packed_jit and
sybil_tpu_torch.ops.scan.scan_packed (the plain versions of K2, K4, K5,
K3, K7, the sorts, K8, K9 and K10): the packed buffers, the keyed tables
and the escalation fetches agree word for word.  Query level: tables
written by sybil_tpu's ingest and digest with CHUNK_SIZE lowered (both
packages' cache.CHUNK_SIZE patched to match) are queried by both
engines uncached, as a cache write on an empty cache directory and as a
cache hit; each package also hits the other's cache files.

Tolerances: 0 for counts, sums, buckets, registers, printed bytes and the
cache files' bytes.  A cached answer merges its groups' partials in
another order than an uncached scan, so the reference's own cached
answer prints the rows of a time bucket or of tied groups in another
order, and its t-digests (built per group, then merged) give other
percentiles: the port's write and hit are held byte for byte to the
reference's write and hit, and to the reference's uncached answer as a
multiset of printed lines and of JSON rows, float means within 1e-12
relative (the t-digest's mean and percentiles left out)."""

import contextlib
import dataclasses
import io
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
import sybil_tpu.query.cache as ref_cache
from sybil_tpu import cli as ref_cli
from sybil_tpu import codec as ref_codec
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.digest import digest_records
from sybil_tpu.ingest import flatten_record
from sybil_tpu.ops import scan as ref
from sybil_tpu.parallel import mesh as ref_mesh
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import FilterDef as RefFilter
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.parallel import mesh as port_mesh
from sybil_tpu_torch.query import cache as port_cache
from sybil_tpu_torch.query import engine as port_engine
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
from sybil_tpu_torch.table import Table


# ---------------------------------------------------------------------------
# batch level
# ---------------------------------------------------------------------------

B, C = 8, 256
R = B * C
NGP = 4
AVG = dict(hist_min=0, bucket_size=0, num_values=0, discard_min=0,
           discard_max=1000)
HIST = dict(hist_min=0, bucket_size=10, num_values=5, discard_min=0,
            discard_max=1000)

# name -> ScanConfig fields past the cache-group key (vg_span 2: two
# blocks a group, NGP groups); "g" a key with MISSING rows, "t" a time
# column (5% missing), "v" the value (0-99: half the rows past a 5-bucket
# hist, so outlier rows are live)
UNIT_CASES = {
    "dense": dict(group_cols=("__cg__", "g"), aggs=(("v", AVG),),
                  key_bounds=((0, NGP), (0, 5))),
    "dense-no-group": dict(group_cols=("__cg__",), aggs=(("v", AVG),),
                           key_bounds=((0, NGP),)),
    "dense-hist-outliers": dict(group_cols=("__cg__", "g"),
                                aggs=(("v", HIST),),
                                key_bounds=((0, NGP), (0, 5)),
                                track_outliers=True),
    "dense-outlier-escalation": dict(group_cols=("__cg__", "g"),
                                     aggs=(("v", HIST),),
                                     key_bounds=((0, NGP), (0, 5)),
                                     track_outliers=True, max_out=16),
    "rollup-vg-first": dict(group_cols=("__cg__", "g"), aggs=(("v", AVG),),
                            key_bounds=((0, NGP), (0, 50), (0, 5)),
                            time_col="t"),
    "rollup-vg-first-windowed": dict(group_cols=("__cg__", "g"),
                                     aggs=(("v", AVG),),
                                     key_bounds=((0, NGP), (0, 50), (0, 5)),
                                     time_col="t", window=64),
    "rollup-hist-outliers": dict(group_cols=("__cg__", "g"),
                                 aggs=(("v", HIST),),
                                 key_bounds=((0, NGP), (0, 50), (0, 5)),
                                 time_col="t", track_outliers=True),
    "dense-spill": dict(group_cols=("__cg__", "g"), aggs=(("v", AVG),),
                        key_bounds=((0, NGP), (0, 3))),
    "sorted": dict(group_cols=("__cg__", "g"), aggs=(("v", AVG),),
                   force_sorted=True),
    "sorted-rollup-hist-outliers": dict(group_cols=("__cg__", "g"),
                                        aggs=(("v", HIST),),
                                        force_sorted=True, time_col="t",
                                        track_outliers=True),
    "sorted-distinct-pairs": dict(group_cols=("__cg__", "g"),
                                  aggs=(("v", AVG),), distinct_cols=("v",)),
    "sorted-packed": dict(group_cols=("__cg__", "g"), aggs=(("v", AVG),),
                          force_sorted=True,
                          sort_pack=((0, NGP), (0, 5))),
}


def unit_batch():
    rng = np.random.default_rng(808)

    def col(v, p):
        return (np.asarray(v, np.int64).reshape(B, C),
                (rng.random(R) < p).reshape(B, C))

    cols = {"g": col(rng.integers(0, 5, R), 0.9),
            "v": col(rng.integers(0, 100, R), 0.9),
            "t": col(np.sort(rng.integers(0, 5000, R)), 0.95)}
    nrec = np.array([C, C - 10, C, 0, C, C, C - 100, C], np.int32)
    return cols, nrec


def unit_config(name):
    o = dict(UNIT_CASES[name])
    aggs = tuple(ref.AggSpec(c, **kw) for c, kw in o.pop("aggs"))
    return ref.ScanConfig(aggs=aggs, filters=(), vg_span=2, **o)


def run_unit(name, tb=100):
    cfg = unit_config(name)
    cols, nrec = unit_batch()
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.zeros(0, jnp.int64), (),
        jnp.asarray(tb, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.zeros(0, dtype=torch.int64), (), tb, {})
    return cfg, pcfg, packed, out, ppacked, raw


@pytest.mark.parametrize("name", sorted(UNIT_CASES))
def test_cache_group_scan_matches_reference(name):
    cfg, pcfg, packed, out, ppacked, raw = run_unit(name)
    assert port.has_cg(pcfg) and pcfg.vg_first == bool(pcfg.time_col)
    assert port.key_layout(pcfg) == (
        ["__cg__"] + ([None] if pcfg.time_col else [])
        + [g for g in pcfg.group_cols if g != "__cg__"])
    want = np.asarray(packed["main"])
    got = ppacked["main"].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    meta = want[0]
    assert (int(meta[1]) > 0) == (name == "dense-spill")
    if "table" in ppacked:
        # K8's key table and K10's keyed table carry the cg lane as K7
        # wrote it
        np.testing.assert_array_equal(ppacked["table"].numpy(),
                                      np.asarray(packed["table"]))
        assert set(np.unique(ppacked["table"].numpy()[
            :int(meta[0]) - 1, 0]).tolist()) == set(range(NGP))
    if pcfg.strategy == "dense":
        np.testing.assert_array_equal(
            port.dense_keys_np(pcfg, 100), ref.dense_keys_np(cfg, 100))
        assert port.windowed(pcfg) == name.endswith("windowed")
    if pcfg.track_outliers:
        # the outlier rows' keys lead with the cache group (K5's key rows,
        # or K9's hist pairs' kmat rows), also past the packed section
        keys, vals = port.fetch_outliers(pcfg, raw, 0)
        mask = np.asarray(out["agg0_out_mask"])
        np.testing.assert_array_equal(keys,
                                      np.asarray(out["sorted_gkeys"])[mask])
        np.testing.assert_array_equal(vals,
                                      np.asarray(out["agg0_out_val"])[mask])
        assert len(vals) > 16
        assert set(keys[:, 0].tolist()) == set(range(NGP))
    if pcfg.distinct_cols:
        pairs = port.fetch_pairs(raw)
        sk = np.asarray(out["sorted_keys"])[np.asarray(out["pair_mask"])]
        np.testing.assert_array_equal(pairs, sk)


def test_key_rows_cg_lane_and_check_supported():
    """key_rows (K5's and the escalation's key source) puts the cache
    group first in both layouts; the scan admits cache-group configs, and
    no_compact_table packs the keyed dense table word for word as the
    reference does: a scan's own table (the row-store scan's form, here
    with the cache-group key decoded from the slot) and a mesh scan's
    merged one."""
    cols = {k: (torch.from_numpy(v), torch.from_numpy(m))
            for k, (v, m) in unit_batch()[0].items()}
    idx = torch.tensor([0, C - 1, C, 3 * C + 5, R - 1])
    for name in ("dense", "rollup-vg-first"):
        pcfg = port.config_from_fields(dataclasses.asdict(unit_config(name)))
        rows = port.key_rows(pcfg, cols, idx, 100)
        assert rows[:, 0].tolist() == [0, 0, 0, 1, 3]
        assert rows.shape[1] == pcfg.n_key_cols
    _, nrec = unit_batch()
    cfg = dataclasses.replace(unit_config("dense"), no_compact_table=True)
    want, _ = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in unit_batch()[0].items()},
        jnp.asarray(nrec), jnp.zeros(0, jnp.int64), (),
        jnp.asarray(100, jnp.int64), {})
    got, _ = port.scan_packed(port.config_from_fields(dataclasses.asdict(cfg)),
                              cols, torch.from_numpy(nrec),
                              torch.zeros(0, dtype=torch.int64), (), 100, {})
    np.testing.assert_array_equal(got["main"].numpy(),
                                  np.asarray(want["main"]))
    keyed = got["main"].numpy()[1:1 + cfg.dense_slots]
    assert set(keyed[keyed[:, 2] > 0, 0].tolist()) == {0, 1, 2, 3}
    # the mesh's keyed table: the same key without the cache group
    cfg = dataclasses.replace(cfg, group_cols=("g",), key_bounds=((0, 5),),
                              vg_span=0)
    out = ref_mesh.sharded_scan(
        cfg, ref_mesh.make_mesh(2),
        {k: (jnp.asarray(v), jnp.asarray(m))
         for k, (v, m) in unit_batch()[0].items()},
        jnp.asarray(nrec), jnp.zeros(0, jnp.int64), (),
        jnp.asarray(100, jnp.int64), {})
    packed = ref.pack_jit(cfg, out, R)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked = port.pack_parts(pcfg, port_mesh.sharded_scan(
        pcfg, port_mesh.Mesh(2), cols, torch.from_numpy(nrec),
        torch.zeros(0, dtype=torch.int64), (), 100, {}))
    np.testing.assert_array_equal(ppacked["main"].numpy(),
                                  np.asarray(packed["main"]))
    keyed = ppacked["main"].numpy()[1:1 + cfg.dense_slots]
    assert set(keyed[keyed[:, 1] > 0, 0].tolist()) == {-1, 0, 1, 2, 3, 4}


# ---------------------------------------------------------------------------
# query level: helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def chunk_size(n):
    """Blocks of n rows for the reference's digest, and n-row blocks as
    FULL for both packages' cache groups."""
    old = (ref_digest.CHUNK_SIZE, ref_cache.CHUNK_SIZE,
           port_cache.CHUNK_SIZE)
    ref_digest.CHUNK_SIZE = ref_cache.CHUNK_SIZE = n
    port_cache.CHUNK_SIZE = n
    try:
        yield
    finally:
        (ref_digest.CHUNK_SIZE, ref_cache.CHUNK_SIZE,
         port_cache.CHUNK_SIZE) = old


def cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


def cache_dir(d, table):
    return os.path.join(d, table, "cache")


def query_files(d, table) -> list[str]:
    """The query cache's files (cache/ also holds the block-info cache)."""
    cd = cache_dir(d, table)
    return sorted(f for f in os.listdir(cd) if f.startswith("q_")) \
        if os.path.isdir(cd) else []


def cache_files(d, table) -> dict:
    out = {}
    for f in query_files(d, table):
        with open(os.path.join(cache_dir(d, table), f), "rb") as fh:
            out[f] = fh.read()
    return out


def clear_cache(d, table):
    for f in query_files(d, table):
        os.remove(os.path.join(cache_dir(d, table), f))


def put_cache(d, table, files: dict):
    clear_cache(d, table)
    os.makedirs(cache_dir(d, table), exist_ok=True)
    for f, data in files.items():
        with open(os.path.join(cache_dir(d, table), f), "wb") as fh:
            fh.write(data)


TD_DROP = ("avg", "percentiles", "sum", "stddev")


def canon(out: str, fmt: str, tdigest: bool = False):
    """An answer as a multiset: its printed lines (text), or its JSON
    rows, each canonically dumped (json; under -tdigest without the
    digest's mean and percentiles)."""
    if fmt == "text":
        return sorted(out.splitlines())

    def row(r):
        if tdigest:
            r = {k: ({kk: vv for kk, vv in v.items() if kk not in TD_DROP}
                     if isinstance(v, dict) else v) for k, v in r.items()}
        return r

    obj = json.loads(out)
    if isinstance(obj, dict):       # a rollup: {time bucket: [rows]}
        return {t: sorted((row(r) for r in rows),
                          key=lambda r: json.dumps(r, sort_keys=True))
                for t, rows in obj.items()}
    return sorted((row(r) for r in obj),
                  key=lambda r: json.dumps(r, sort_keys=True))


def assert_same(got, want, path="answer"):
    """Equal, ints exactly and floats within 1e-12 relative."""
    if isinstance(want, float) or isinstance(got, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0), \
            (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def configs_seen(monkeypatch):
    """Every (ScanConfig, raw outputs) the port's engine scans."""
    seen = []
    real = port.scan_packed

    def spy(cfg, *args, **kw):
        packed, raw = real(cfg, *args, **kw)
        seen.append((cfg, raw))
        return packed, raw

    monkeypatch.setattr(port, "scan_packed", spy)
    return seen


# ---------------------------------------------------------------------------
# query level: the tables
# ---------------------------------------------------------------------------

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
VG_CHUNK = 64


@pytest.fixture(scope="module")
def vg(tmp_path_factory):
    """100 full blocks of 64 rows and a partial one: six cache groups and
    five uncacheable blocks (four full, one partial), time-sorted over
    three days.  At -device-batch 64 the missed groups ride two
    dispatches of four vgroups: [g1..g4], and [g5, g6, the rest blocks]
    padded to four (ng = 3, ngp = 4)."""
    d = str(tmp_path_factory.mktemp("vg"))
    rng = np.random.default_rng(71)
    n = 100 * VG_CHUNK + 30
    u = rng.random(n)
    latency = np.where(u < 0.004, rng.integers(90000, 300000, n),
                       np.where(u < 0.02, rng.integers(20000, 40000, n),
                                np.abs(rng.normal(3000, 800, n))))
    with chunk_size(VG_CHUNK):
        RefTable("vg", RefFlags(dir=d, table="vg",
                                skip_compact=True)).ingest_columns(
            ints={"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
                  "latency": latency.astype(np.int64),
                  "weight": rng.choice([1, 10, 100], n).astype(np.int64),
                  "time": 1_700_000_000 + rng.integers(0, 3 * 86400, n),
                  "h": rng.integers(0, 151, n),
                  "uid": rng.integers(0, 300, n)},
            strs={"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
                  "status": [STATII[i] for i in rng.integers(0, 5, n)]},
            valid={"host": rng.random(n) > 0.07,
                   "ping": rng.random(n) > 0.1,
                   "weight": rng.random(n) > 0.2})
    return d


@pytest.fixture(scope="module")
def spill(tmp_path_factory):
    """Two cache groups of 64-row blocks and a partial block; the int key g
    has one value past its outlier-resistant IntInfo bound, and the first
    block's exact bounds are removed (a block written before they
    existed), so the dense key bound spills."""
    d = str(tmp_path_factory.mktemp("spill"))
    rng = np.random.default_rng(77)
    n = 33 * VG_CHUNK + 20
    g = rng.integers(0, 20, n).astype(np.int64)
    g[1500] = 1_000_000
    with chunk_size(VG_CHUNK):
        RefTable("spill", RefFlags(dir=d, table="spill",
                                   skip_compact=True)).ingest_columns(
            ints={"g": g, "v": rng.integers(0, 100, n)})
    first = sorted(b for b in os.listdir(os.path.join(d, "spill"))
                   if b.startswith("block"))[0]
    info = os.path.join(d, "spill", first, "info.json")
    meta = ref_codec.read_json(info)
    meta["int_exact"] = {}
    ref_codec.write_json_atomic(info, meta)
    return d


PAIRS_CHUNK = 1100


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Two cache groups of 1,100-row blocks (C = 2048) and a partial block,
    a distinct value a row: at -device-batch 32 both groups share one
    dispatch whose 35,200 (group, distinct) pairs pass the packed
    section's 2 x 16,384 rows, so the pairs escalate; 800 groups, below
    the accumulator's prune cap of 1,000."""
    d = str(tmp_path_factory.mktemp("pairs"))
    rng = np.random.default_rng(5)
    n = 32 * PAIRS_CHUNK + 300
    with chunk_size(PAIRS_CHUNK):
        RefTable("pairs", RefFlags(dir=d, table="pairs",
                                   skip_compact=True)).ingest_columns(
            ints={"u": np.arange(n, dtype=np.int64) * 7,
                  "g": rng.integers(0, 800, n)})
    return d


# name -> (table fixture, CLI arguments past -dir/-table, -device-batch,
# what the vgroup configs must show)
QUERIES = {
    # dense, shared form, the columnar split
    "group-avg": ("vg", ["-group", "host", "-int", "ping", "-op", "avg"],
                  64, "shared"),
    # no group column: the cache-group key alone
    "count-avg": ("vg", ["-int", "ping", "-op", "avg"], 64, "shared"),
    # a time rollup: [cg, time, host], K2's windowed form
    "time-avg-windowed": ("vg", ["-group", "host", "-int", "ping", "-op",
                                 "avg", "-time", "-time-bucket", "3600",
                                 "-time-col", "time"], 64, "windowed"),
    # (cg, host, h) past the shared table: K2's global form; every one
    # of the 906 groups printed (a limit would pick among tied groups by
    # merge order; past 1,000 groups the accumulator's prune would too)
    "two-keys-global": ("vg", ["-group", "host,h", "-int", "ping,latency",
                               "-op", "avg", "-weight-col", "weight",
                               "-limit", "5000"], 64, "global"),
    # the sorted strategy: K7, the sorts, K8, K9, K10 with the cg lane
    "tdigest": ("vg", ["-group", "host", "-int", "ping", "-op", "hist",
                       "-tdigest", "-str-filter", "status:neq:404"], 64,
                "sorted"),
    # dense histograms with live outlier rows: K5's cg key rows
    "loghist-outliers": ("vg", ["-group", "status", "-int", "latency",
                                "-op", "hist", "-loghist"], 64, "outliers"),
    # the device HLL, more live groups than the shipped planes
    "distinct-hll": ("vg", ["-group", "host", "-int", "ping", "-distinct",
                            "uid"], 64, "hll"),
    "time-distinct-hll": ("vg", ["-int", "ping", "-distinct", "host",
                                 "-time", "-time-bucket", "21600",
                                 "-time-col", "time"], 64, "hll"),
    # (group, distinct) pairs past the packed section, split by cg
    "op-distinct-pairs": ("pairs", ["-group", "g", "-int", "u", "-distinct",
                                    "u", "-limit", "5000"], 32, "pairs"),
    # below 16 blocks a batch no vgroup fits: one group a batch through
    # _scan_dirs(groups=...), the rest scanned uncached after it
    "group-avg-batch-8": ("vg", ["-group", "host", "-int", "ping", "-op",
                                 "hist"], 8, "fallback"),
    # a dense key bound that spills: the chunk is redone on the sorted
    # strategy
    "spill-retry": ("spill", ["-group", "g", "-int", "v", "-op", "avg"], 64,
                    "spill"),
}
TABLE = {"vg": "vg", "spill": "spill", "pairs": "pairs"}
CHUNK = {"vg": VG_CHUNK, "spill": VG_CHUNK, "pairs": PAIRS_CHUNK}


def check_shapes(name, seen):
    """What the vgroup configs of a query's cache write must show."""
    vgs = [(cfg, raw) for cfg, raw in seen if port.has_cg(cfg)]
    what = QUERIES[name][3]
    if what == "fallback":
        # six groups of two batches each, then the five rest blocks
        assert not vgs and len(seen) == 6 * 2 + 1
        return
    assert vgs, f"{name}: no cache-group scan ran"
    ngps = sorted({cfg.key_bounds[0][1] for cfg, _ in vgs})
    if what in ("shared", "global", "windowed", "outliers"):
        forms = {port.dense_scan_path(cfg) for cfg, _ in vgs
                 if cfg.strategy == "dense"}
        assert forms == {"windowed" if what == "windowed" else
                         "global" if what == "global" else "shared"}
        # seven vgroups (six groups and the rest) in two dispatches of
        # four: the second holds three, padded to four
        assert ngps == [4] and len(vgs) == 2
    if what == "sorted":
        assert {cfg.strategy for cfg, _ in vgs} == {"sorted"}
        assert all(not cfg.sort_pack for cfg, _ in vgs)
    if what == "outliers":
        assert all(cfg.track_outliers for cfg, _ in vgs)
        live = sum(int(raw["agg0_out_mask"].sum()) for _, raw in vgs)
        assert live > 0
    if what == "hll":
        assert all(cfg.hll for cfg, _ in vgs)
        assert any(int(cfg.hll_ship) >= 2 * cfg.key_bounds[0][1]
                   for cfg, _ in vgs)
    if what == "pairs":
        assert all(cfg.distinct_cols and cfg.strategy == "sorted"
                   for cfg, _ in vgs)
        big = [raw for cfg, raw in vgs if cfg.key_bounds[0][1] == 2]
        assert big and int(big[0]["pair_mask"].sum()) > 2 * 16384
    if what == "spill":
        assert any(cfg.force_sorted for cfg, _ in vgs)
        assert any(not cfg.force_sorted for cfg, _ in vgs)


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_cached_query_matches_reference(request, name, fmt, monkeypatch):
    """Uncached, cache write and cache hit: the port's bytes equal the
    reference's in each mode, the write's cache files equal the
    reference's byte for byte, and the cached answers equal the
    reference's uncached answer as multisets; in -json each package
    then hits the other's files."""
    fixture, argv, batch, _ = QUERIES[name]
    d = request.getfixturevalue(fixture)
    table = TABLE[fixture]
    base = ["query", "-dir", d, "-table", table, "-device-batch",
            str(batch), *argv] + (["-json"] if fmt == "json" else [])
    cq = ["-cache-queries"]
    pd = ["-device", "cpu"]
    td = "-tdigest" in argv
    with chunk_size(CHUNK[fixture]):
        clear_cache(d, table)
        want = cli(ref_cli.main, base)
        ref_write = cli(ref_cli.main, base + cq)
        ref_files = cache_files(d, table)
        ngroups = len(ref_files)
        assert ngroups >= 2
        ref_hit = cli(ref_cli.main, base + cq)
        assert cli(port_cli.main, base + pd) == want
        clear_cache(d, table)
        seen = configs_seen(monkeypatch)
        m0 = port_cache.MISSES
        got_write = cli(port_cli.main, base + cq + pd)
        assert port_cache.MISSES - m0 == ngroups
        check_shapes(name, seen)
        assert got_write == ref_write
        assert cache_files(d, table) == ref_files
        h0, m0 = port_cache.HITS, port_cache.MISSES
        got_hit = cli(port_cli.main, base + cq + pd)
        assert (port_cache.HITS - h0, port_cache.MISSES - m0) == (ngroups, 0)
        assert got_hit == ref_hit
        if not (td and fmt == "text"):
            for got in (got_write, got_hit):
                assert_same(canon(got, fmt, td), canon(want, fmt, td))
        if fmt == "json":
            # the reference hits the port's files, the port the
            # reference's
            h0 = ref_cache.HITS
            assert cli(ref_cli.main, base + cq) == ref_hit
            assert ref_cache.HITS - h0 == ngroups
            put_cache(d, table, ref_files)
            h0 = port_cache.HITS
            assert cli(port_cli.main, base + cq + pd) == ref_hit
            assert port_cache.HITS - h0 == ngroups
        clear_cache(d, table)


def test_fallback_distinct_limit_counts_the_union(vg, monkeypatch):
    """One group a batch (_scan_dirs(groups=...)) with -distinct-limit:
    the limit counts the union of the groups' keys, as the reference's
    does, so both stop at the same group, cache the same partials, and
    answer alike."""
    params = dict(groups=("h",), aggs=(("ping", "avg"),),
                  num_distinct=151)
    with chunk_size(VG_CHUNK):
        clear_cache(vg, "vg")
        rf = RefFlags(dir=vg, table="vg", device_batch=8,
                      cache_queries=True)
        want = ref_run_query(RefTable("vg", rf), RefParams(
            groups=params["groups"], aggs=(RefAgg("ping", "avg"),),
            num_distinct=params["num_distinct"]), rf)
        ref_files = cache_files(vg, "vg")
        clear_cache(vg, "vg")
        seen = configs_seen(monkeypatch)
        flags = Flags(dir=vg, table="vg", device="cpu", device_batch=8,
                      cache_queries=True)
        got = run_query(Table("vg", flags), QueryParams(
            groups=params["groups"], aggs=(AggDef("ping", "avg"),),
            num_distinct=params["num_distinct"]), flags)
        assert cache_files(vg, "vg") == ref_files
        clear_cache(vg, "vg")
    assert not any(port.has_cg(cfg) for cfg, _ in seen)
    # h has 151 values: the union reaches them all within the first
    # groups, so the scan stops before the others
    assert 0 < len(ref_files) < 6 and len(seen) < 6 * 2
    assert {k: (r.count, r.samples) for k, r in got.results.items()} == \
        {k: (r.count, r.samples) for k, r in want.results.items()}
    assert got.matched_count == want.matched_count


def test_hit_launches_nothing_and_new_group_misses(vg, monkeypatch):
    """A query whose groups all hit scans nothing (its six groups cover
    every block but the rest, which is scanned uncached); a group whose
    block changes misses alone."""
    with chunk_size(VG_CHUNK):
        clear_cache(vg, "vg")
        flags = Flags(dir=vg, table="vg", device="cpu", device_batch=64,
                      cache_queries=True)
        params = QueryParams(groups=("host",), aggs=(AggDef("ping", "avg"),))
        first = run_query(Table("vg", flags), params, flags)
        seen = configs_seen(monkeypatch)
        h0, m0 = port_cache.HITS, port_cache.MISSES
        again = run_query(Table("vg", flags), params, flags)
        assert (port_cache.HITS - h0, port_cache.MISSES - m0) == (6, 0)
        # only the five rest blocks are scanned, uncached, in one batch
        assert len(seen) == 1 and not port.has_cg(seen[0][0])
        assert snap(again) == snap(first)
        clear_cache(vg, "vg")


# ---------------------------------------------------------------------------
# the reference's cache tests (tests/test_cache_readlog.py), on the port
# ---------------------------------------------------------------------------

def make_blocks(tmp_path, n_blocks=20, chunk=64, per=64):
    """tests/test_cache_readlog.py:make_blocks: a table of n_blocks FULL
    blocks, written by the reference's ingest and digest."""
    d = str(tmp_path / "db")
    t = RefTable("t", RefFlags(dir=d, table="t", skip_compact=True))
    with chunk_size(chunk):
        n = n_blocks * per
        t.ingest_records([flatten_record({"x": i % 7, "v": i, "time": i})
                          for i in range(n)])
        digest_records(t)
    flags = Flags(dir=d, table="t", skip_compact=True, device_batch=4,
                  device="cpu")
    return d, flags, n


def cflags(flags):
    return dataclasses.replace(flags, cache_queries=True)


def snap(qr):
    return ({k: (r.count, r.samples,
                 {c: (h.count, h.avg) for c, h in r.hists.items()})
             for k, r in qr.results.items()}, qr.matched_count,
            [r.group_key for r in qr.sorted])


def test_query_cache_roundtrip(tmp_path):
    d, flags, n = make_blocks(tmp_path)
    params = QueryParams(groups=("x",), aggs=(AggDef("v", "avg"),))
    with chunk_size(64):
        qr1 = run_query(Table("t", flags), params, cflags(flags))
        assert [f for f in os.listdir(cache_dir(d, "t"))
                if f.startswith("q_")]
        h0 = port_cache.HITS
        qr2 = run_query(Table("t", flags), params, cflags(flags))
        assert port_cache.HITS > h0
    assert snap(qr2) == snap(qr1)
    assert sum(r.count for r in qr2.results.values()) == n
    for k in qr1.results:
        assert abs(qr1.results[k].hists["v"].mean()
                   - qr2.results[k].hists["v"].mean()) < 1e-12
    assert snap(run_query(Table("t", flags), params, flags)) == snap(qr1)


def test_query_cache_survives_new_blocks(tmp_path):
    d, flags, n = make_blocks(tmp_path)
    params = QueryParams(groups=("x",))
    with chunk_size(64):
        qr1 = run_query(Table("t", flags), params, cflags(flags))
        assert sum(r.count for r in qr1.results.values()) == n
        t = RefTable("t", RefFlags(dir=d, table="t", skip_compact=True))
        t.ingest_records([flatten_record({"x": 0, "v": 1, "time": 10**9})
                          for _ in range(200)])
        digest_records(t)
        h0, m0 = port_cache.HITS, port_cache.MISSES
        qr2 = run_query(Table("t", flags), params, cflags(flags))
        assert port_cache.HITS - h0 >= 1
        assert port_cache.MISSES - m0 <= 1
    assert sum(r.count for r in qr2.results.values()) == n + 200
    want = ref_run_query(RefTable("t", RefFlags(dir=d, table="t")),
                         RefParams(groups=("x",)),
                         RefFlags(dir=d, table="t", device_batch=4))
    assert {k: r.count for k, r in qr2.results.items()} == \
        {k: r.count for k, r in want.results.items()}


def test_query_cache_time_sliding_filter(tmp_path):
    d, flags, n = make_blocks(tmp_path)
    with chunk_size(64):
        run_query(Table("t", flags), QueryParams(
            groups=("x",), filters=(FilterDef("time", "gt", "-5", "int"),)),
            cflags(flags))
        h0 = port_cache.HITS
        qr = run_query(Table("t", flags), QueryParams(
            groups=("x",), filters=(FilterDef("time", "gt", "-3", "int"),)),
            cflags(flags))
        assert port_cache.HITS > h0
    assert sum(r.count for r in qr.results.values()) == n


def test_query_cache_groups_survive_filter_constant_changes(tmp_path):
    d, flags, n = make_blocks(tmp_path, n_blocks=40)

    def q(cut, P=QueryParams, A=AggDef, F=FilterDef):
        return P(groups=("x",), aggs=(A("v", "avg"),),
                 filters=(F("time", "gt", str(cut), "int"),))

    with chunk_size(64):
        run_query(Table("t", flags), q(300), cflags(flags))
        h0 = port_cache.HITS
        qr2 = run_query(Table("t", flags), q(500), cflags(flags))
        assert port_cache.HITS > h0, "filter-constant change wiped the cache"
    plain = run_query(Table("t", flags), q(500), flags)
    want = ref_run_query(RefTable("t", RefFlags(dir=d, table="t")),
                         q(500, RefParams, RefAgg, RefFilter),
                         RefFlags(dir=d, table="t", device_batch=4))
    assert snap(qr2)[:2] == snap(plain)[:2]
    assert {k: r.count for k, r in qr2.results.items()} == \
        {k: r.count for k, r in want.results.items()}


def vg_table(tmp_path, name, rec):
    d = str(tmp_path / "db")
    t = RefTable(name, RefFlags(dir=d, table=name, skip_compact=True))
    with chunk_size(128):
        t.ingest_records([flatten_record(rec(i)) for i in range(128 * 40)])
        digest_records(t)
    assert len(t.list_block_dirs()) >= 32
    return d, Flags(dir=d, table=name, skip_compact=True, device_batch=256,
                    device="cpu")


def test_cache_vgroup_batch_parity(tmp_path, monkeypatch):
    d, flags = vg_table(tmp_path, "vg",
                        lambda i: {"g": f"k{i % 9}", "v": i % 50, "time": i})
    params = QueryParams(groups=("g",), aggs=(AggDef("v", "avg"),))
    base = run_query(Table("vg", flags), params, flags)
    called = {}
    real = port_engine._scan_cache_vgroups

    def spy(ctx, groups, B, vg_cap):
        called["n"] = len(groups)
        return real(ctx, groups, B, vg_cap)

    monkeypatch.setattr(port_engine, "_scan_cache_vgroups", spy)
    with chunk_size(128):
        port_cache.HITS = port_cache.MISSES = 0
        wrote = run_query(Table("vg", flags), params, cflags(flags))
        assert called.get("n", 0) >= 2, "vgroup path did not engage"
        hit = run_query(Table("vg", flags), params, cflags(flags))
    assert port_cache.HITS > 0
    assert snap(wrote) == snap(base)
    assert snap(hit) == snap(base)
    assert wrote.matched_count == base.matched_count == 128 * 40


def test_cache_vgroup_rollup_parity(tmp_path):
    d, flags = vg_table(tmp_path, "vgr", lambda i: {
        "g": f"k{i % 4}", "v": i % 40, "time": i * 3})
    params = QueryParams(groups=("g",), aggs=(AggDef("v", "avg"),),
                         time_bucket=100, time_col="time")
    base = run_query(Table("vgr", flags), params, flags)
    with chunk_size(128):
        port_cache.HITS = port_cache.MISSES = 0
        wrote = run_query(Table("vgr", flags), params, cflags(flags))
        hit = run_query(Table("vgr", flags), params, cflags(flags))
    assert port_cache.HITS > 0

    def rsnap(qr):
        out = {}
        for tb, rows in qr.time_results.items():
            for gk, r in rows.items():
                h = r.hists.get("v")
                out[(tb, gk)] = (r.count, r.samples,
                                 h.mean() if h else None)
        return out

    assert rsnap(wrote) == rsnap(base)
    assert rsnap(hit) == rsnap(base)
    assert wrote.matched_count == base.matched_count == 128 * 40
