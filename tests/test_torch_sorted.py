"""Port of the sorted scan strategy (K7-K10 plain versions, K5 over the
sorted keys) and the engine's spill retry, against the JAX reference.

Scan level: the same numpy batch goes through sybil_tpu.ops.scan.
scan_packed_jit and sybil_tpu_torch.ops.scan.scan_packed (CPU tensors);
the packed `main` buffer, the keyed group table and the raw arrays that
escalation fetches (the sparse hist pairs, the outlier mask and values,
the sorted keys) must agree word for word.

Query level: small tables answer -tdigest, a rollup past
DENSE_WINDOW_SLOT_CAP, high-cardinality packed str groups with a missing
column, a batch with more groups than the packed prefix and more hist
pairs than Hcap (both fetched from the device), the group cap, a dense
key bound that spills and is retried on the sorted strategy, and config
1 over more than 16 blocks with the default -limit;
run_query's results and the CLI's printed bytes (text and -json) must
equal the reference's.  Every compared value is an integer, a bool or
printed text, or a float the two packages compute by the same steps:
equality is exact."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.ops import scan as ref
from sybil_tpu.query import engine as ref_engine
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query import engine as port_engine
from sybil_tpu_torch.query.spec import QueryParams
from sybil_tpu_torch.table import Table

B, C = 3, 1024
R = B * C
MULTI = ((200, 300, 8, 20, 0), (100, 199, 4, 20, 20), (0, 99, 3, 30, 40))

# name -> options.  keys: [(lo, hi) of the values, pack bound (min,
# card) or None]; time: (lo, hi, bucket, time_i32) of a time key; hist:
# "basic" | "multi" | "tdigest" | None per aggregation; filters: (col,
# op, kind, constant); weight; track: outlier tracking; extra: ScanConfig
# fields
CASES = {
    "packed-int32": dict(keys=[((0, 9), (0, 9)), ((0, 7), (0, 7))],
                         hist=[None]),
    "packed-int64": dict(keys=[((0, 60000), (0, 60000)),
                               ((0, 50000), (0, 50000))], hist=[None]),
    "packed-spill": dict(keys=[((0, 12), (0, 9)), ((0, 4), (0, 4))],
                         hist=["basic"], track=True),
    # values of min - 1 pack as digit 0, as MISSING does
    "packed-min-minus-one": dict(keys=[((4, 14), (5, 9)), ((0, 3), (0, 3))],
                                 hist=[None]),
    "unpacked-missing-negative": dict(
        keys=[((-5, 4), None), ((-3, 3), None), ((-1000, 1000), None)],
        hist=[None, None]),
    "time-i32": dict(keys=[((0, 9), None)], time=(-40_000, 90_000, 100,
                                                   True), hist=[None]),
    "time-i64-hist": dict(keys=[((0, 5), None)],
                          time=((1 << 33) - 500_000, (1 << 33) + 500_000,
                                7, False), hist=["basic"], track=True),
    "filters-int-str-regex": dict(keys=[((0, 9), (0, 9))], hist=["basic"],
                                  filters=[("fi", "gt", "int", 10),
                                           ("fs", "neq", "str", 4),
                                           ("fs", "re", "str", 0)]),
    "weighted-hist-outliers": dict(keys=[((0, 6), None), ((0, 3), None)],
                                   hist=["basic", None], weight=True,
                                   track=True),
    "multihist-sub-outliers": dict(keys=[((0, 6), (0, 6))],
                                   hist=["multi"], weight=True, track=True),
    "tdigest-layout": dict(keys=[((0, 4), (0, 4))], hist=["tdigest"],
                           track=True),
    "group-cap": dict(keys=[((0, 400), None)], hist=["basic"],
                      extra=dict(max_groups=50)),
    "groups-past-prefix": dict(keys=[((0, 700), (0, 700))], hist=[None],
                               extra=dict(prefix_rows=64)),
    "pairs-past-hcap": dict(keys=[((0, 30), None)], hist=["basic"],
                            weight=True, extra=dict(max_hist_pairs=40)),
    "outliers-past-max-out": dict(keys=[((0, 3), (0, 3))], hist=["basic"],
                                  track=True, extra=dict(max_out=8)),
    "no-keys-vbias": dict(keys=[], hist=[None, "basic"], vbias=True),
}


def _make(name):
    """-> (reference ScanConfig, {col: (values, valid)}, nrec, filter
    constants, regex bitsets, time bucket)."""
    o = CASES[name]
    rng = np.random.default_rng(4000 + sorted(CASES).index(name))
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    groups, pack = [], []
    for i, ((lo, hi), pb) in enumerate(o["keys"]):
        put(f"k{i}", rng.integers(lo, hi, R), 0.9)
        groups.append(f"k{i}")
        pack.append(pb)
    tkw, tb = {}, 1
    if "time" in o:
        lo, hi, tb, i32 = o["time"]
        put("t", rng.integers(lo, hi, R), 0.95)
        tkw = dict(time_col="t", time_i32=i32)
        pack = []                          # a time key is never packed
    aggs = []
    for a, h in enumerate(o["hist"]):
        put(f"v{a}", np.where(rng.random(R) < 0.03,
                              rng.integers(500, 3000, R),
                              rng.integers(-20, 400, R)), 0.85)
        if h is None:
            aggs.append(ref.AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                    num_values=0, discard_min=-10,
                                    discard_max=2500))
        elif h == "multi":
            aggs.append(ref.AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                    num_values=70, discard_min=0,
                                    discard_max=2500, sub_edges=MULTI))
        elif h == "tdigest":
            # value-identity buckets (engine.py:176-184): nv = span + 2
            aggs.append(ref.AggSpec(f"v{a}", hist_min=0, bucket_size=1,
                                    num_values=2002, discard_min=0,
                                    discard_max=2500))
        else:
            aggs.append(ref.AggSpec(f"v{a}", hist_min=0, bucket_size=10,
                                    num_values=40, discard_min=0,
                                    discard_max=2500))
    filters, fvals = [], []
    if o.get("filters"):
        put("fi", rng.integers(0, 80, R), 0.9)
        put("fs", rng.integers(0, 10, R), 0.9)
        for col, op, kind, val in o["filters"]:
            filters.append(ref.FilterSpec(col, op, kind,
                                          0 if op in ("re", "nre") else -1))
            fvals.append(val)
    bits = (np.array([i % 3 == 0 for i in range(10)]),)
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    vbias = tuple(a.discard_min for a in aggs) if o.get("vbias") else ()
    sort_pack = tuple(pack) if pack and all(p is not None for p in pack) \
        else ()
    cfg = ref.ScanConfig(
        group_cols=tuple(groups), aggs=tuple(aggs), filters=tuple(filters),
        weight_col="w" if o.get("weight") else "", force_sorted=True,
        sort_pack=sort_pack, track_outliers=bool(o.get("track")),
        agg_vbias=vbias, **tkw, **o.get("extra", {}))
    nrec = np.array([C, 700, C - 3], dtype=np.int32)
    return cfg, cols, nrec, np.asarray(fvals, np.int64), bits, tb


def _run_both(name):
    cfg, cols, nrec, fvals, bits, tb = _make(name)
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(tb, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), tuple(torch.from_numpy(b) for b in bits),
        tb)
    return cfg, pcfg, packed, out, ppacked, raw


@pytest.mark.parametrize("name", sorted(CASES))
def test_sorted_scan_matches_reference(name):
    cfg, pcfg, packed, out, ppacked, raw = _run_both(name)
    assert cfg.strategy == "sorted" and pcfg.strategy == "sorted"
    assert port.sort_packed(pcfg) == bool(cfg.sort_pack)
    want = np.asarray(packed["main"])
    got = ppacked["main"].numpy()
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ppacked["table"].numpy(),
                                  np.asarray(packed["table"]))
    for ai in port.hist_aggs(pcfg):
        for key in ("hp_mask", "hp_bv", "hp_w", "hp_keys"):
            np.testing.assert_array_equal(
                raw[f"agg{ai}_{key}"].numpy(),
                np.asarray(out[f"agg{ai}_{key}"]), err_msg=key)
        if pcfg.track_outliers:
            for key in ("out_mask", "out_val"):
                np.testing.assert_array_equal(
                    raw[f"agg{ai}_{key}"].numpy(),
                    np.asarray(out[f"agg{ai}_{key}"]), err_msg=key)
            np.testing.assert_array_equal(raw["kmat"].numpy(),
                                          np.asarray(out["sorted_gkeys"]))
    # each case reaches the edge it is named for
    meta = want[0]
    H = len(port.hist_aggs(pcfg))
    layout = port.packed_layout(pcfg, R)
    assert int(meta[0]) > 0
    assert (int(meta[1]) > 0) == (name == "packed-spill")
    if name == "packed-int64":
        assert port.pack_sentinel(pcfg)[1] == torch.int64
    if name == "packed-int32":
        assert port.pack_sentinel(pcfg)[1] == torch.int32
    if name == "group-cap":
        assert int(meta[0]) > pcfg.max_groups
    if name == "groups-past-prefix":
        assert int(meta[0]) > port.table_prefix(pcfg)
    if name == "pairs-past-hcap":
        assert int(meta[7 + H]) > layout["Hcap"]
    if name == "outliers-past-max-out":
        assert int(meta[2]) > layout["kmax_out"]
    if pcfg.track_outliers and name != "packed-spill":
        assert int(meta[2]) > 0


def _strategies_seen(monkeypatch):
    """Record the strategy of every ScanConfig the port's engine scans."""
    seen = []
    real = port.scan_packed

    def spy(cfg, *args, **kw):
        seen.append(cfg.strategy)
        return real(cfg, *args, **kw)

    monkeypatch.setattr(port, "scan_packed", spy)
    return seen


@pytest.mark.parametrize("what,change,item", [
    ("distinct", {"distinct_cols": ("v0",)}, "B9"),
    ("device prune", {"prune_topk": 1000}, "B10"),
    ("samples", {"want_matched_mask": True}, "A13"),
])
def test_sorted_shapes_still_unported_raise(what, change, item):
    """The device prune (B10), distinct counts (B9, the distinct pairs)
    and samples (A13, the matched mask) are ported and equal the
    reference's `main`, (pruned) table and mask word for word."""
    cfg, cols, nrec, fvals, bits, tb = _make("unpacked-missing-negative")
    pcfg = dataclasses.replace(
        port.config_from_fields(dataclasses.asdict(cfg)), **change)
    assert pcfg.strategy == "sorted"
    tcols = {k: (torch.from_numpy(v), torch.from_numpy(m))
             for k, (v, m) in cols.items()}
    packed, out = ref.scan_packed_jit(
        dataclasses.replace(cfg, **change),
        {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
         cols.items()}, jnp.asarray(nrec), jnp.zeros((0,), jnp.int64),
        (), jnp.asarray(1, jnp.int64), {})
    got, raw = port.scan_packed(pcfg, tcols, torch.from_numpy(nrec))
    np.testing.assert_array_equal(got["main"].numpy(),
                                  np.asarray(packed["main"]))
    np.testing.assert_array_equal(got["table"].numpy(),
                                  np.asarray(packed["table"]))
    meta = np.asarray(packed["main"])[0]
    if item == "B10":
        assert int(meta[4]) == port.table_prefix(pcfg)
    elif item == "B9":
        assert int(meta[2]) > 0                     # npairs
    else:
        np.testing.assert_array_equal(raw["matched"].numpy(),
                                      np.asarray(out["matched"]))
        assert 0 < int(raw["matched"].sum()) == int(nrec.sum())


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
ACTIONS = ["pageload", "pageunload", "click", "notif", "hover", "tooltip",
           "type", "chat", "comment"]


def _ingest(table, chunk, steps):
    """Ingest (ints, strs, valid) steps with `chunk` rows a block."""
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = chunk
    try:
        for ints, strs, valid in steps:
            table.ingest_columns(ints=ints, strs=strs, valid=valid)
    finally:
        ref_digest.CHUNK_SIZE = old


@pytest.fixture(scope="module")
def uptime(tmp_path_factory):
    """uptime as bench.py shapes it (hosts, statuses, |N(60, 20)| pings,
    weights in {1, 10, 100}), with missing rows, a heavy-tailed latency
    and a 4000-value index, 6 blocks of 1024 rows."""
    d = str(tmp_path_factory.mktemp("sorted_uptime"))
    rng = np.random.default_rng(71)
    n = 6000
    u = rng.random(n)
    latency = np.where(u < 0.01, rng.integers(20000, 90000, n),
                       np.abs(rng.normal(3000, 800, n))).astype(np.int64)
    steps = [({"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
               "weight": rng.choice([1, 10, 100], n).astype(np.int64),
               "index_int": np.arange(n, dtype=np.int64) % 4000,
               "latency": latency},
              {"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
               "status": [STATII[i] for i in rng.integers(0, 5, n)]},
              {"host": rng.random(n) > 0.07, "ping": rng.random(n) > 0.11,
               "weight": rng.random(n) > 0.2})]
    _ingest(RefTable("uptime", RefFlags(dir=d, table="uptime",
                                        skip_compact=True)), 1024, steps)
    return d


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """user_sessions as activity_generator shapes it: time over four
    weeks, 9 actions, weights in {1, 10, 100}, a latency with a tail,
    16 blocks of 512 rows."""
    d = str(tmp_path_factory.mktemp("sorted_sessions"))
    rng = np.random.default_rng(73)
    n = 8192
    latency = np.where(rng.random(n) < 0.01, rng.integers(5000, 9000, n),
                       rng.integers(0, 400, n)).astype(np.int64)
    steps = [({"time": 1_755_000_000 - rng.integers(0, 4 * 7 * 86400, n),
               "weight": rng.choice([1, 10, 100], n).astype(np.int64),
               "latency": latency},
              {"action": [ACTIONS[i] for i in rng.integers(0, 9, n)]},
              {"time": rng.random(n) > 0.03, "action": rng.random(n) > 0.05})]
    _ingest(RefTable("user_sessions", RefFlags(
        dir=d, table="user_sessions", skip_compact=True)), 512, steps)
    return d


@pytest.fixture(scope="module")
def many_users(tmp_path_factory):
    """High-cardinality str groups (tests/test_query_features.py:249-272,
    cut to 2 x 6000 rows and a flatter law, so the dictionary still
    passes the dense slot cap): the first ingest lacks the second str
    column."""
    d = str(tmp_path_factory.mktemp("sorted_users"))
    rng = np.random.default_rng(3)
    n = 6000
    uid = rng.zipf(1.1, n) % 9000
    steps = [({"v": rng.integers(0, 50, n).astype(np.int64)},
              {"u": [f"person{x}" for x in uid]}, {}),
             ({"v": rng.integers(0, 50, n).astype(np.int64)},
              {"u": [f"person{x}" for x in uid],
               "u2": [f"g{x % 7}" for x in uid]}, {})]
    _ingest(RefTable("users", RefFlags(dir=d, table="users",
                                       skip_compact=True)), 2048, steps)
    return d


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """20,000 distinct int keys g in 3 blocks of 8192 rows, a 3-value str
    column h and a value v: one batch holds more groups than the packed
    prefix, and more (h, g) hist pairs than Hcap."""
    d = str(tmp_path_factory.mktemp("sorted_wide"))
    rng = np.random.default_rng(75)
    n = 20_000
    steps = [({"g": np.arange(n, dtype=np.int64),
               "v": rng.integers(0, 100, n).astype(np.int64)},
              {"h": [("a", "b", "c")[i] for i in rng.integers(0, 3, n)]},
              {"v": rng.random(n) > 0.05})]
    _ingest(RefTable("wide", RefFlags(dir=d, table="wide",
                                      skip_compact=True)), 8192, steps)
    return d


# name -> (table fixture, table, CLI arguments past -dir/-table)
QUERIES = {
    # config 3 with -tdigest: this slice's path 1
    "tdigest-config-3": ("uptime", "uptime",
                         ["-group", "host", "-int", "ping", "-op", "hist",
                          "-tdigest", "-str-filter", "status:eq:200"]),
    "tdigest-weighted": ("uptime", "uptime",
                         ["-group", "status", "-int", "latency", "-op",
                          "hist", "-tdigest", "-weight-col", "weight"]),
    # 4000 quotients x 6 x 6 slots: past DENSE_WINDOW_SLOT_CAP
    "rollup-past-window-cap": ("uptime", "uptime",
                               ["-time", "-time-col", "index_int",
                                "-time-bucket", "1", "-group",
                                "host,status", "-int", "ping"]),
    # int group keys, exactly bounded: the packed sort
    "int-group-keys": ("uptime", "uptime",
                       ["-group", "index_int,weight", "-int", "ping"]),
    "sorted-hist": ("uptime", "uptime",
                    ["-group", "index_int,status", "-int", "ping", "-op",
                     "hist", "-weight-col", "weight"]),
    "sorted-loghist-outliers": ("uptime", "uptime",
                                ["-group", "index_int,host", "-int",
                                 "latency", "-op", "hist", "-loghist"]),
    # config 4 at 5-minute buckets: this slice's path 2
    "config-4-5min": ("sessions", "user_sessions",
                      ["-group", "action", "-int", "weight", "-time",
                       "-time-bucket", "300", "-time-col", "time"]),
    # the time key and sparse hist pairs together: -tdigest forces the
    # sorted strategy at daily buckets
    "config-4-daily-tdigest": ("sessions", "user_sessions",
                               ["-group", "action", "-int", "latency",
                                "-op", "hist", "-tdigest", "-time",
                                "-time-bucket", "86400", "-time-col",
                                "time"]),
    "packed-str-missing-column": ("many_users", "users",
                                  ["-group", "u,u2", "-int", "v"]),
    # 20,000 groups in one batch: the table past its packed prefix is
    # fetched from the device
    "groups-past-prefix": ("wide", "wide", ["-group", "g", "-int", "v"]),
    # 20,000 (h, g) pairs in one batch: past Hcap, fetched from the device
    "hist-pairs-past-hcap": ("wide", "wide",
                             ["-group", "h", "-int", "g", "-op", "hist",
                              "-tdigest"]),
}


def _cli_out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


# queries whose batch overflows a packed section: the engine fetches the
# rest from the device through this helper
ESCALATES = {"groups-past-prefix": "fetch_table",
             "hist-pairs-past-hcap": "fetch_hist_pairs"}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sorted_query_output_matches_reference(request, name, capsys,
                                               monkeypatch):
    fixture, table, extra = QUERIES[name]
    d = request.getfixturevalue(fixture)
    seen = _strategies_seen(monkeypatch)
    fetched = []
    if name in ESCALATES:
        real_fetch = getattr(port, ESCALATES[name])

        def fetch(*args):
            fetched.append(args)
            return real_fetch(*args)
        monkeypatch.setattr(port, ESCALATES[name], fetch)
    for fmt in (["-json"], []):
        argv = ["query", "-dir", d, "-table", table, "-device-batch", "4",
                *extra, *fmt]
        want = _cli_out(ref_cli.main, argv, capsys)
        got = _cli_out(port_cli.main, argv + ["-device", "cpu"], capsys)
        assert got == want
        if fmt:
            assert len(json.loads(got)) >= 3
    assert set(seen) == {"sorted"}
    assert bool(fetched) == (name in ESCALATES)


def _result_state(qr):
    """Every row of a result: keys, counts, hist count/avg/min/max,
    buckets, outliers, percentiles, stddev; per time bucket too."""
    def hist(h):
        st = [h.count, h.avg, getattr(h, "min", None), getattr(h, "max", None),
              tuple(np.asarray(getattr(h, "values", ())).tolist()),
              tuple(getattr(h, "outliers", ()) or ())]
        if h.percentile_mode:
            st += [tuple(h.get_percentiles()), h.get_stddev()]
        return tuple(st)

    def rows(results):
        return {k: (tuple(r.key_tuple), r.count, r.samples,
                    {c: hist(h) for c, h in r.hists.items()})
                for k, r in results.items()}
    return (rows(qr.results),
            {tb: rows(rs) for tb, rs in qr.time_results.items()},
            (qr.cumulative.count, qr.cumulative.samples), qr.matched_count,
            [r.group_key for r in qr.sorted])


@pytest.mark.parametrize("name,max_groups", [
    ("tdigest-config-3", 0), ("sorted-hist", 0),
    ("config-4-daily-tdigest", 0), ("packed-str-missing-column", 0),
    ("hist-pairs-past-hcap", 0),
    # the group cap: 20,000 groups under max_groups = 5000
    ("groups-past-prefix", 5000)])
def test_sorted_run_query_matches_reference(request, name, max_groups):
    fixture, table, extra = QUERIES[name]
    d = request.getfixturevalue(fixture)
    argv = ["-dir", d, "-table", table, "-device-batch", "4", *extra]
    want = ref_engine.run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        _ref_params(argv), RefFlags(dir=d, table=table, device_batch=4,
                                    tdigest="-tdigest" in argv,
                                    max_groups=max_groups))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=4,
                  tdigest="-tdigest" in argv, max_groups=max_groups)
    got = port_engine.run_query(Table(table, flags), _port_params(argv),
                                flags)
    assert _result_state(got) == _result_state(want)
    assert len(got.results) >= 3


def _ref_params(argv):
    from sybil_tpu.cli import _flags_from_query_args, _query_parser
    return RefParams.from_flags(_flags_from_query_args(
        _query_parser().parse_args(argv)))


def _port_params(argv):
    from sybil_tpu_torch.cli import _flags_from_query_args, _query_parser
    return QueryParams.from_flags(_flags_from_query_args(
        _query_parser().parse_args(argv)))


def _spill_table(d: str):
    """An int group key whose table IntInfo ignores one outlier value
    (the outlier-resistant update, table_column_info.go:75-131), with one
    block's exact bounds removed, as a block written before they existed
    has none: the bind keeps the IntInfo bound, the dense scan spills."""
    import os

    from sybil_tpu import codec
    rng = np.random.default_rng(77)
    n = 2048
    g = rng.integers(0, 20, n).astype(np.int64)
    g[1500] = 1_000_000
    t = RefTable("spill", RefFlags(dir=d, table="spill", skip_compact=True))
    _ingest(t, 512, [({"g": g, "v": rng.integers(0, 100, n)
                       .astype(np.int64)}, {}, {})])
    blocks = sorted(b for b in os.listdir(os.path.join(d, "spill"))
                    if b.startswith("block"))
    info = os.path.join(d, "spill", blocks[0], "info.json")
    meta = codec.read_json(info)
    meta["int_exact"] = {}
    codec.write_json_atomic(info, meta)
    return d


def test_dense_spill_is_retried_on_the_sorted_strategy(tmp_path, capsys,
                                                        monkeypatch):
    d = _spill_table(str(tmp_path))
    seen = _strategies_seen(monkeypatch)
    ref_seen = []
    real = ref_engine._Accumulator.absorb_packed

    def spy(self, packed, out, R, config=None):
        ref_seen.append((config or self.bound.config).strategy)
        return real(self, packed, out, R, config)

    monkeypatch.setattr(ref_engine._Accumulator, "absorb_packed", spy)
    outs = []
    for fmt in (["-json"], []):
        argv = ["query", "-dir", d, "-table", "spill", "-group", "g", "-int",
                "v", "-device-batch", "2", *fmt]
        want = _cli_out(ref_cli.main, argv, capsys)
        outs.append(_cli_out(port_cli.main, argv + ["-device", "cpu"],
                             capsys))
        assert outs[-1] == want
    # both engines scanned dense, spilled, and rescanned both batches
    # sorted, once per query
    assert seen == ["dense", "dense", "sorted", "sorted"] * 2
    assert ref_seen[0] == "dense" and ref_seen.count("sorted") == 4
    assert any(r["g"] == "1000000" for r in json.loads(outs[0]))


def test_config_1_past_16_blocks_with_the_default_limit(tmp_path, capsys,
                                                        monkeypatch):
    """More than 16 blocks and the default -limit 100: the bind asks for
    prune_topk = 1000, which the dense strategy ignores."""
    d = str(tmp_path)
    rng = np.random.default_rng(79)
    n = 20 * 256
    _ingest(RefTable("uptime", RefFlags(dir=d, table="uptime",
                                        skip_compact=True)), 256,
            [({"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64)},
              {"host": [HOSTS[i] for i in rng.integers(0, 5, n)]},
              {"ping": rng.random(n) > 0.1})])
    prunes = []
    real = port_engine._maybe_device_prune

    def spy(bound, *args):
        real(bound, *args)
        prunes.append((bound.config.prune_topk, bound.config.strategy))

    monkeypatch.setattr(port_engine, "_maybe_device_prune", spy)
    for fmt in (["-json"], []):
        argv = ["query", "-dir", d, "-table", "uptime", "-group", "host",
                "-int", "ping", "-device-batch", "4", *fmt]
        want = _cli_out(ref_cli.main, argv, capsys)
        got = _cli_out(port_cli.main, argv + ["-device", "cpu"], capsys)
        assert got == want
    assert prunes == [(1000, "dense")] * 2
