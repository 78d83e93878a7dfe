"""Port time rollups (the time key and the windowed reduce in K2, the
time key of K5's outlier rows) against the JAX reference.

Scan level: the same numpy batch goes through sybil_tpu.ops.scan.
scan_packed_jit and sybil_tpu_torch.ops.scan.scan_packed (CPU tensors)
with the same time bucket; the packed download buffer `main` must agree
word for word, and so must the raw outputs escalation fetches.

Query level: small multi-block user_sessions-shaped tables answer
`-time -time-bucket` queries; run_query's time results and the CLI's
printed bytes (text and -json) must equal the reference's.  Every
ingest sorts its rows by time before it slices them into blocks
(save_column_batch), so a table written by one ingest has blocks that
each span a narrow band of time buckets, and a table written by one
ingest per block has blocks that each span the whole range: the bind
windows both, with a narrow and a wide window.  Every output is an
integer, a bool or printed text: equality is exact."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sybil_tpu.digest as ref_digest
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.ops import scan as ref
from sybil_tpu.query import engine as ref_engine
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, QueryParams
from sybil_tpu_torch.table import Table

B, C = 3, 1024
R = B * C
TB = 1000

# name -> options.  time: (lo, hi) of the time values; qb: the time key's
# (min quotient, card); keys: group key bounds; window/chunk: the bind's
# windowed reduce; i32: time_i32; tvalid: share of rows with the time
# column; hist: a tracked histogram (outlier rows carry the time key)
CASES = {
    "not-windowed": dict(),
    "windowed": dict(window=128, chunk=256),
    "windowed-one-band-chunks": dict(window=256, chunk=0, sort=True),
    "i32-negative-times": dict(time=(-60_000, 40_000), qb=(-60, 101)),
    "i64-negative-times": dict(time=(-(1 << 40), 1 << 40), i32=False,
                               tb=1 << 34, qb=(-64, 129), window=128,
                               chunk=512),
    "i64-beyond-2-31": dict(time=((1 << 31) + 5, (1 << 31) + 90_000),
                            i32=False, qb=(2147483, 91)),
    "rows-missing-time": dict(tvalid=0.6, window=128, chunk=512),
    "spilled-quotient": dict(qb=(10, 20)),
    "spilled-quotient-windowed": dict(qb=(-5, 30), window=128, chunk=256),
    "two-group-keys": dict(keys=[(0, 5), (-2, 4)], window=256, chunk=512),
    "filter": dict(filters=[("f", "gt", "int", 30)]),
    "hist-outliers": dict(hist=True),
    "hist-outliers-windowed-i64": dict(hist=True, i32=False, window=128,
                                       chunk=256, time=(-50_000, 50_000),
                                       qb=(-50, 101)),
    "no-group-keys": dict(keys=[], hist=True, window=0),
}


def _make(name):
    """-> (reference ScanConfig, {col: (values, valid)}, nrec, time
    bucket)."""
    o = CASES[name]
    rng = np.random.default_rng(2000 + sorted(CASES).index(name))
    cols = {}

    def put(col, v, m):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C), m.reshape(B, C))

    lo, hi = o.get("time", (0, 100_000))
    t = rng.integers(lo, hi, R)
    if o.get("sort"):
        t = np.sort(t)
    put("t", t, rng.random(R) < o.get("tvalid", 0.97))
    tb = o.get("tb", TB)
    bounds = o.get("keys", [(0, 5)])
    for i, (mn, card) in enumerate(bounds):
        put(f"k{i}", rng.integers(mn, mn + card, R), rng.random(R) < 0.9)
    put("v", rng.integers(-200, 700, R), rng.random(R) < 0.85)
    put("f", rng.integers(0, 80, R), rng.random(R) < 0.9)
    if o.get("hist"):
        agg = ref.AggSpec("v", hist_min=0, bucket_size=10, num_values=20,
                          discard_min=0, discard_max=650)
    else:
        agg = ref.AggSpec("v", hist_min=0, bucket_size=0, num_values=0,
                          discard_min=-100, discard_max=600)
    qb = o.get("qb", (0, 100))
    filters = tuple(ref.FilterSpec(c, op, kind, -1)
                    for c, op, kind, _ in o.get("filters", ()))
    fvals = [val for *_, val in o.get("filters", ())]
    cfg = ref.ScanConfig(
        group_cols=tuple(f"k{i}" for i in range(len(bounds))), aggs=(agg,),
        filters=filters, time_col="t", key_bounds=(qb, *bounds),
        track_outliers=bool(o.get("hist")), window=o.get("window", 0),
        window_chunk=o.get("chunk", 0), time_i32=o.get("i32", True),
        max_out=64)
    nrec = np.array([C, 700, C - 1], dtype=np.int32)
    return cfg, cols, nrec, np.asarray(fvals, dtype=np.int64), tb


def _run_both(name):
    cfg, cols, nrec, fvals, tb = _make(name)
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
              cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals), (),
        jnp.asarray(tb, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), (), tb)
    return cfg, pcfg, np.asarray(packed["main"]), out, \
        ppacked["main"].numpy(), raw


@pytest.mark.parametrize("name", sorted(CASES))
def test_rollup_scan_main_matches_reference(name):
    cfg, pcfg, want, out, got, raw = _run_both(name)
    o = CASES[name]
    assert cfg.strategy == "dense"
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert int(want[0, 0]) > 0                       # live groups
    assert (int(want[0, 1]) > 0) == ("spilled" in name)
    if o.get("window"):
        assert 0 < cfg.window < cfg.dense_slots
        assert port.dense_scan_path(pcfg) == "windowed"
        assert port.reduce_space(pcfg)[2] is False   # no compaction
    else:
        assert port.dense_scan_path(pcfg) != "windowed"
    if o.get("hist"):
        nout = int(want[0, 2])
        assert nout > 0
        mask = np.asarray(out["agg0_out_mask"])
        keys, vals = port.fetch_outliers(pcfg, raw, 0)
        gkeys = np.asarray(out["sorted_gkeys"])
        assert gkeys.shape[1] == pcfg.n_key_cols == 1 + len(cfg.group_cols)
        np.testing.assert_array_equal(keys, gkeys[mask])
        np.testing.assert_array_equal(
            vals, np.asarray(out["agg0_out_val"])[mask])
        # the packed rows' first key column is the time key
        off, kmax = port.packed_layout(pcfg, R)["out0"]
        np.testing.assert_array_equal(
            got[off: off + min(nout, kmax), 0], gkeys[mask][:kmax, 0])


@pytest.mark.parametrize("name", ["windowed", "i64-negative-times",
                                  "hist-outliers-windowed-i64"])
def test_rollup_kernel_forms_agree_on_cpu(name):
    """The plain K2 is what every kernel form is held to on the card:
    its sums and min/max must not depend on the window, and the
    windowed reduce space is the uncompacted slot table."""
    cfg, cols, nrec, fvals, tb = _make(name)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    tcols = {k: (torch.from_numpy(v), torch.from_numpy(m))
             for k, (v, m) in cols.items()}
    w = port.dense_scan_plain(pcfg, tcols, torch.from_numpy(nrec),
                              torch.from_numpy(fvals), (), tb)
    flat = port.dense_scan_plain(dataclasses.replace(pcfg, window=0), tcols,
                                 torch.from_numpy(nrec),
                                 torch.from_numpy(fvals), (), tb)
    slots, Sc, compact = port.reduce_space(
        dataclasses.replace(pcfg, window=0))
    n = Sc - 1 if compact else Sc
    assert torch.equal(w["sums"][:n], flat["sums"][:n])
    assert not w["sums"][n:].any()
    assert torch.equal(w["spill"], flat["spill"])
    # the windowed kernel's own plan: the whole reduce space resident in
    # shared memory, or chunks that tile a block with a band of slots
    band, chunk = port.window_band(pcfg, C)
    wSc = port.reduce_space(pcfg)[1]
    assert (chunk == 0 and band == wSc) or (0 < band < wSc and
                                            C % chunk == 0)


# the windowed form's corner cases, as chip_smoke.py builds them for the
# card (larger there): the reference's windowed _scan_dense against the
# plain K2 that every kernel path is held to on the card
SCAN_DENSE = jax.jit(ref._scan_dense, static_argnums=(0,))


@pytest.mark.parametrize("name", list(chip_smoke.K2W_CASES))
def test_windowed_case_matches_reference(name):
    fields, cols, nrec, fvals, tb = chip_smoke.k2w_case(name, 2, 2048)
    o = dict(fields)
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o["aggs"])
    o["filters"] = tuple(ref.FilterSpec(*f, -1) for f in o["filters"])
    cfg = ref.ScanConfig(**o)
    pcfg = chip_smoke.k2w_config(port, fields)
    assert port.config_from_fields(dataclasses.asdict(cfg)) == pcfg
    assert 0 < cfg.window < cfg.dense_slots
    assert port.dense_scan_path(pcfg) == "windowed"
    want = SCAN_DENSE(cfg, {k: (jnp.asarray(v), jnp.asarray(m))
                            for k, (v, m) in cols.items()},
                      jnp.asarray(nrec), jnp.asarray(fvals), (),
                      jnp.asarray(tb, jnp.int64), {})
    got = port.dense_scan_plain(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), (), tb)
    sums = got["sums"].numpy()
    assert sums.shape == (cfg.dense_slots, 2 + 3 * len(cfg.aggs))
    np.testing.assert_array_equal(sums[:, 0], np.asarray(want["count"]))
    np.testing.assert_array_equal(sums[:, 1], np.asarray(want["samples"]))
    hist = port.hist_aggs(pcfg)
    for ai in range(len(cfg.aggs)):
        np.testing.assert_array_equal(sums[:, 2 + 3 * ai] > 0,
                                      np.asarray(want[f"agg{ai}_exists"]))
        np.testing.assert_array_equal(sums[:, 3 + 3 * ai],
                                      np.asarray(want[f"agg{ai}_count"]))
        np.testing.assert_array_equal(sums[:, 4 + 3 * ai],
                                      np.asarray(want[f"agg{ai}_wv"]))
        if ai in hist:
            j = hist.index(ai)
            np.testing.assert_array_equal(got["mins"][:, j].numpy(),
                                          np.asarray(want[f"agg{ai}_min"]))
            np.testing.assert_array_equal(got["maxs"][:, j].numpy(),
                                          np.asarray(want[f"agg{ai}_max"]))
    assert int(got["spill"][0]) == int(want["spill"])
    assert (int(want["spill"]) > 0) == ("spilled" in name)
    assert (int(np.asarray(want["count"]).sum()) == 0) == ("no matched"
                                                            in name)
    if cfg.want_matched_mask:
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(want["matched"]))
    if "one slot" in name:
        assert int((sums[:, 1] > 0).sum()) == 1


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

ACTIONS = ["pageload", "pageunload", "click", "notif", "hover", "tooltip",
           "type", "chat", "comment"]
N_ROWS = 8192


def _sessions(d: str, one_ingest: bool):
    """user_sessions as activity_generator shapes it (action, weight in
    {1, 10, 100}, time over four weeks), 16 blocks of 512 rows, written
    by one ingest (blocks narrow in time) or by one ingest per block
    (each block spans the four weeks)."""
    rng = np.random.default_rng(31)
    n = N_ROWS
    time = 1_755_000_000 - rng.integers(0, 4 * 7 * 86400, n)
    action = rng.integers(0, len(ACTIONS), n)
    weight = rng.choice([1, 10, 100], n).astype(np.int64)
    latency = np.where(rng.random(n) < 0.01, rng.integers(5000, 9000, n),
                       rng.integers(0, 400, n)).astype(np.int64)
    tvalid = rng.random(n) > 0.03
    avalid = rng.random(n) > 0.05
    t = RefTable("user_sessions", RefFlags(dir=d, table="user_sessions",
                                           skip_compact=True))
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 512
    step = n if one_ingest else 512
    try:
        for lo in range(0, n, step):
            sl = slice(lo, lo + step)
            t.ingest_columns(
                ints={"time": time[sl], "weight": weight[sl],
                      "latency": latency[sl]},
                strs={"action": [ACTIONS[i] for i in action[sl]]},
                valid={"time": tvalid[sl], "action": avalid[sl]})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


@pytest.fixture(scope="module")
def narrow_table(tmp_path_factory):
    return _sessions(str(tmp_path_factory.mktemp("rollup_narrow")), True)


@pytest.fixture(scope="module")
def wide_table(tmp_path_factory):
    return _sessions(str(tmp_path_factory.mktemp("rollup_wide")), False)


# name -> (groups, agg column, op, time bucket)
QUERIES = {
    "c4-hourly-avg-weight": (("action",), "weight", "avg", 3600),
    "daily-hist-latency": (("action",), "latency", "hist", 86400),
    "no-groups-hourly": ((), "weight", "avg", 3600),
}


def _params(name, agg_cls, params_cls):
    groups, col, op, tb = QUERIES[name]
    return params_cls(groups=groups, aggs=(agg_cls(col, op),),
                      time_bucket=tb, time_col="time")


def _time_snapshot(qr):
    out = {}
    for tb, rs in qr.time_results.items():
        for k, r in rs.items():
            hs = {}
            for c, h in r.hists.items():
                hs[c] = (h.count, h.avg, h.min, h.max,
                         tuple(np.asarray(getattr(h, "values", ())).tolist()),
                         tuple(getattr(h, "outliers", ()) or ()))
            out[(tb, k)] = (r.count, r.samples, hs)
    return out


@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_rollup_query_matches_reference(request, name, layout):
    d = request.getfixturevalue(f"{layout}_table")
    seen = {}
    real = ref_engine.BoundQuery.apply_exact_bounds

    def spy(self, infos, dirs):
        real(self, infos, dirs)
        seen["config"] = self.config

    ref_engine.BoundQuery.apply_exact_bounds = spy
    try:
        want = ref_run_query(
            RefTable("user_sessions", RefFlags(dir=d, table="user_sessions")),
            _params(name, RefAgg, RefParams),
            RefFlags(dir=d, table="user_sessions", device_batch=8))
    finally:
        ref_engine.BoundQuery.apply_exact_bounds = real
    flags = Flags(dir=d, table="user_sessions", device="cpu",
                  device_batch=8)
    got = run_query(Table("user_sessions", flags),
                    _params(name, AggDef, QueryParams), flags)
    assert seen["config"].strategy == "dense"
    if name.startswith("c4"):
        # the bind windows config 4's rollup on both layouts: one band
        # of 128 slots per narrow block, 896 for blocks that span it all
        assert seen["config"].dense_slots == 6784
        assert seen["config"].window == (128 if layout == "narrow"
                                         else 896)
    snap = _time_snapshot(got)
    assert snap == _time_snapshot(want)
    assert len(snap) > 20
    assert got.matched_count == want.matched_count


def _cli_out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["-json", "text"])
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("name", ["c4-hourly-avg-weight",
                                  "daily-hist-latency"])
def test_rollup_cli_output_matches_reference_bytes(request, name, layout,
                                                   fmt, capsys):
    d = request.getfixturevalue(f"{layout}_table")
    groups, col, op, tb = QUERIES[name]
    argv = ["query", "-dir", d, "-table", "user_sessions", "-int", col,
            "-op", op, "-time", "-time-bucket", str(tb), "-time-col",
            "time", "-device-batch", "8"]
    if groups:
        argv += ["-group", ",".join(groups)]
    if fmt == "-json":
        argv.append("-json")
    want = _cli_out(ref_cli.main, argv, capsys)
    got = _cli_out(port_cli.main, argv + ["-device", "cpu"], capsys)
    assert got == want
    if fmt == "-json":
        assert len(json.loads(got)) > 20
