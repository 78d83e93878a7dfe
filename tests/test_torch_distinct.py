"""Port of count distinct (the device HLL, K13 and K3's HLL sections; the
sorted strategy's distinct pairs, K7's distinct lanes, K8's pair mask and
K10's pair section) against the JAX reference.

Function level: hash_int_col_plain, hll_idx_rank_plain and the register
planes equal sybil_tpu.ops.scan's _hash_int_col, _hll_idx_rank and
_hll_registers on seeded inputs, exactly, in both of the reference's
register forms (pair existence for a small str dictionary, rows for a
large one or an int column) and for a crafted hash whose low 50 bits are
zero.  Scan level: the same numpy batch goes through scan_packed_jit and
the port's scan_packed (CPU tensors); `main`, the register planes and the
sorted keys of the pairs agree word for word.  Query level: run_query's
distinct counts and the CLI's printed bytes (text and -json) equal the
reference's, through both escalations (more live groups than shipped
planes, more pairs than the packed section) and -distinct-limit."""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
import sybil_tpu_torch.digest as port_digest
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.ops import scan as ref
from sybil_tpu.query.engine import BoundQuery as RefBound
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query.engine import BoundQuery, run_query
from sybil_tpu_torch.query.spec import QueryParams
from sybil_tpu_torch.table import Table

B, C = 3, 1024
R = B * C
I64 = np.iinfo(np.int64)


# ---------------------------------------------------------------------------
# function level
# ---------------------------------------------------------------------------

def _u64_bits(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64).view(np.int64)


def test_hash_int_col_matches_reference():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.integers(I64.min, I64.max, 5000, dtype=np.int64),
                        rng.integers(-300, 300, 600),
                        [I64.min, I64.max, -1, 0, 1, 255, 256]]).astype(
                            np.int64)
    got = port.hash_int_col_plain(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _u64_bits(ref._hash_int_col(
        jnp.asarray(v))))


def test_hll_idx_rank_matches_reference():
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2 ** 63, 6000, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 6000, dtype=np.uint64)
    # crafted: the low 64 - HLL_P bits zero (rest == 0), one bit set at
    # every position below the index, all ones, zero
    crafted = [np.uint64(k) << np.uint64(64 - ref.HLL_P)
               for k in (0, 1, 77, (1 << ref.HLL_P) - 1)]
    crafted += [np.uint64(1) << np.uint64(b) for b in range(64 - ref.HLL_P)]
    crafted += [np.uint64(2 ** 64 - 1)]
    h = np.concatenate([h, np.array(crafted, dtype=np.uint64)])
    idx, rank = port.hll_idx_rank_plain(torch.from_numpy(h.view(np.int64)))
    ridx, rrank = ref._hll_idx_rank(jnp.asarray(h))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rrank))
    assert int(rank[-len(crafted) + 1]) == 64 - ref.HLL_P + 1   # rest == 0


# ---------------------------------------------------------------------------
# scan level: the dense strategy's device HLL
# ---------------------------------------------------------------------------

# name -> options.  keys: key bounds (min, card); dict: a str distinct
# column's dictionary size (the hash array has dict + 1 entries), or None
# for an int column; crafted: hash entries with rest == 0; nrec; time:
# (lo, hi, bucket) of a time key; filters
HLL_CASES = {
    "str-pair-form": dict(keys=[(0, 5)], dict=40),
    "str-row-form": dict(keys=[(0, 5)], dict=6000),
    "int-row-form": dict(keys=[(0, 5)], dict=None),
    "int-no-groups": dict(keys=[], dict=None),
    "crafted-rest-zero": dict(keys=[(0, 3)], dict=30, crafted=True),
    "every-row-unmatched": dict(keys=[(0, 5)], dict=40, nrec=(0, 0, 0)),
    "live-slots-past-phll": dict(keys=[(0, 4), (0, 5)], dict=None),
    "time-key-filters": dict(keys=[(0, 3)], dict=25, time=(1000, 5000, 500),
                             filters=True),
}


def _hll_make(name):
    o = HLL_CASES[name]
    rng = np.random.default_rng(100 + sorted(HLL_CASES).index(name))
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    groups, bounds = [], []
    tkw, tb = {}, 1
    if "time" in o:
        lo, hi, tb = o["time"]
        put("t", rng.integers(lo, hi, R), 0.95)
        tkw = dict(time_col="t")
        bounds.append((lo // tb, (hi - lo) // tb + 1))
    for i, (mn, card) in enumerate(o["keys"]):
        put(f"k{i}", rng.integers(mn, mn + card, R), 0.9)
        groups.append(f"k{i}")
        bounds.append((mn, card))
    bits, hidx = (), -1
    if o["dict"] is None:
        v = np.where(rng.random(R) < 0.02, rng.choice(
            [I64.min, I64.max, -1, -7], R), rng.integers(-5000, 100000, R))
        put("d", v, 0.9)
    else:
        put("d", rng.integers(0, o["dict"], R), 0.9)
        hashes = rng.integers(0, 2 ** 63, o["dict"] + 1, dtype=np.uint64) * \
            np.uint64(2)
        if o.get("crafted"):
            hashes[::3] = (np.arange(len(hashes[::3]), dtype=np.uint64)
                           << np.uint64(64 - ref.HLL_P))
        bits, hidx = (hashes,), 0
    filters, fvals = [], []
    if o.get("filters"):
        put("fi", rng.integers(0, 80, R), 0.9)
        filters = [ref.FilterSpec("fi", "gt", "int"),
                   ref.FilterSpec("k0", "neq", "str")]
        fvals = [10, 2]
    cfg = ref.ScanConfig(group_cols=tuple(groups), aggs=(),
                         filters=tuple(filters), distinct_cols=("d",),
                         key_bounds=tuple(bounds), hll=True,
                         hll_hash_idx=hidx, **tkw)
    nrec = np.array(o.get("nrec", (C, 700, C - 3)), dtype=np.int32)
    return cfg, cols, nrec, np.asarray(fvals, np.int64), bits, tb


def _run_both(cfg, cols, nrec, fvals, bits, tb):
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(tb, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    pbits = tuple(torch.from_numpy(b.view(np.int64) if b.dtype == np.uint64
                                   else b) for b in bits)
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), pbits, tb)
    return pcfg, packed, out, ppacked, raw


@pytest.mark.parametrize("name", sorted(HLL_CASES))
def test_device_hll_scan_matches_reference(name):
    cfg, cols, nrec, fvals, bits, tb = _hll_make(name)
    pcfg, packed, out, ppacked, raw = _run_both(cfg, cols, nrec, fvals, bits,
                                                tb)
    assert cfg.strategy == "dense" and pcfg.strategy == "dense"
    np.testing.assert_array_equal(raw["hll_regs"].numpy(),
                                  np.asarray(out["hll_regs"]))
    np.testing.assert_array_equal(ppacked["main"].numpy(),
                                  np.asarray(packed["main"]))
    np.testing.assert_array_equal(port.fetch_hll(raw),
                                  np.asarray(out["hll_regs"]))
    # each case reaches the form or edge it is named for
    layout = port.packed_layout(pcfg, R)
    live = int(np.asarray(packed["main"])[0, 0])
    g = int(np.prod([card + 1 for _, card in cfg.key_bounds]))
    if bits:
        pair_form = (g + 1) * len(bits[0]) <= 32768
        assert pair_form == (name in ("str-pair-form", "crafted-rest-zero",
                                      "time-key-filters",
                                      "every-row-unmatched"))
    if name == "live-slots-past-phll":
        assert live > layout["Phll"]
    if name == "every-row-unmatched":
        assert live == 0
    if name == "crafted-rest-zero":
        assert int(np.asarray(out["hll_regs"]).max()) == 64 - ref.HLL_P + 1


# ---------------------------------------------------------------------------
# scan level: the sorted strategy's distinct pairs
# ---------------------------------------------------------------------------

# name -> options.  keys: (lo, hi) of the group keys; dist: (lo, hi) of
# the distinct columns; hist: add a histogram aggregation (its pair
# sections follow the distinct section); max_pairs; nrec
PAIR_CASES = {
    "d1-past-kmax-pairs": dict(keys=[(0, 30)], dist=[(-50, 50)],
                               max_pairs=64),
    "d2-filter-weight": dict(keys=[(0, 6), (-3, 3)], dist=[(0, 9), (-4, 4)],
                             filter=True, weight=True),
    "d1-hist-agg": dict(keys=[(0, 8)], dist=[(0, 400)], hist=True,
                        max_pairs=100),
    "d1-no-groups": dict(keys=[], dist=[(0, 2000)]),
    "d1-every-row-unmatched": dict(keys=[(0, 5)], dist=[(0, 9)],
                                   nrec=(0, 0, 0)),
}


def _pairs_make(name):
    o = PAIR_CASES[name]
    rng = np.random.default_rng(200 + sorted(PAIR_CASES).index(name))
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    groups = []
    for i, (lo, hi) in enumerate(o["keys"]):
        put(f"k{i}", rng.integers(lo, hi, R), 0.9)
        groups.append(f"k{i}")
    dist = []
    for j, (lo, hi) in enumerate(o["dist"]):
        put(f"d{j}", rng.integers(lo, hi, R), 0.85)
        dist.append(f"d{j}")
    aggs = []
    if o.get("hist"):
        put("v", rng.integers(0, 400, R), 0.9)
        aggs.append(ref.AggSpec("v", hist_min=0, bucket_size=10,
                                num_values=40, discard_min=0,
                                discard_max=2500))
    filters, fvals = [], []
    if o.get("filter"):
        put("fi", rng.integers(0, 80, R), 0.9)
        filters, fvals = [ref.FilterSpec("fi", "lt", "int")], [60]
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    cfg = ref.ScanConfig(group_cols=tuple(groups), aggs=tuple(aggs),
                         filters=tuple(filters), distinct_cols=tuple(dist),
                         weight_col="w" if o.get("weight") else "",
                         max_pairs=o.get("max_pairs", 16384))
    nrec = np.array(o.get("nrec", (C, 700, C - 3)), dtype=np.int32)
    return cfg, cols, nrec, np.asarray(fvals, np.int64), (), 1


@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_distinct_pairs_scan_matches_reference(name):
    cfg, cols, nrec, fvals, bits, tb = _pairs_make(name)
    pcfg, packed, out, ppacked, raw = _run_both(cfg, cols, nrec, fvals, bits,
                                                tb)
    assert cfg.strategy == "sorted" and pcfg.strategy == "sorted"
    assert not port.sort_packed(pcfg)
    want = np.asarray(packed["main"])
    np.testing.assert_array_equal(ppacked["main"].numpy(), want)
    np.testing.assert_array_equal(ppacked["table"].numpy(),
                                  np.asarray(packed["table"]))
    pm = np.asarray(out["pair_mask"])
    np.testing.assert_array_equal(raw["pair_mask"].numpy(), pm)
    np.testing.assert_array_equal(port.fetch_pairs(raw),
                                  np.asarray(out["sorted_keys"])[pm])
    npairs = int(want[0, 2 + len(port.hist_aggs(pcfg))])
    layout = port.packed_layout(pcfg, R)
    if name == "d1-every-row-unmatched":
        assert npairs == 0
    elif "past-kmax" in name or name == "d1-hist-agg":
        assert npairs > layout["kmax_pairs"]


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]


@pytest.fixture(scope="module")
def uptime(tmp_path_factory):
    """A small uptime table (2,000 rows, 4 blocks), as the reference's
    engine tests shape it: host, status, ping, index_int."""
    d = str(tmp_path_factory.mktemp("distinct_up"))
    rng = np.random.default_rng(31)
    n = 2000
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 512
    try:
        RefTable("uptime", RefFlags(dir=d, table="uptime",
                                    skip_compact=True)).ingest_columns(
            ints={"ping": rng.integers(0, 200, n),
                  "index_int": np.arange(n, dtype=np.int64) * 3 - 1000,
                  "time": 1_700_000_000 + rng.integers(0, 86400, n)},
            strs={"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
                  "status": [STATII[i] for i in rng.integers(0, 5, n)]},
            valid={"status": rng.random(n) > 0.05,
                   "ping": rng.random(n) > 0.1})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


def _cardinalities(qr) -> dict:
    return {k: (r.count, r.distinct.cardinality()
                if r.distinct is not None else None)
            for k, r in qr.results.items()}


def _both(d, table, device_batch, **params):
    want = ref_run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        RefParams(**params), RefFlags(dir=d, table=table,
                                      device_batch=device_batch))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=device_batch)
    got = run_query(Table(table, flags), QueryParams(**params), flags)
    return want, got


@pytest.mark.parametrize("batch", [1, 16])
def test_distinct(uptime, batch):
    """tests/test_query_engine.py:200: group by host, distinct status
    (the device HLL, a str column's hash array)."""
    want, got = _both(uptime, "uptime", batch, groups=("host",),
                      distincts=("status",))
    assert _cardinalities(got) == _cardinalities(want)
    assert all(3 <= c <= 7 for _, c in _cardinalities(got).values())
    for k, r in want.results.items():
        np.testing.assert_array_equal(got.results[k].distinct.registers,
                                      r.distinct.registers)


def test_distinct_device_hll_int_col(uptime):
    """tests/test_query_engine.py:224: an int distinct column hashes in
    K13 (hll_hash_idx -1); the estimates equal the host HLL's."""
    flags = Flags(dir=uptime, table="uptime", device="cpu")
    params = QueryParams(groups=("status",), distincts=("index_int",))
    t = Table("uptime", flags)
    t.load_info()
    bound = BoundQuery(t, params, flags)
    assert bound.config.hll and bound.config.hll_hash_idx == -1
    rt = RefTable("uptime", RefFlags(dir=uptime, table="uptime"))
    rt.load_info()
    ref_bound = RefBound(rt, RefParams(groups=("status",),
                                       distincts=("index_int",)),
                         RefFlags(dir=uptime, table="uptime"))
    assert dataclasses.asdict(bound.config) == dataclasses.asdict(
        ref_bound.config)
    want, got = _both(uptime, "uptime", 2, groups=("status",),
                      distincts=("index_int",))
    assert _cardinalities(got) == _cardinalities(want)


@pytest.fixture(scope="module")
def hllesc(tmp_path_factory):
    """tests/test_query_engine.py:240's table: 20 groups (> hll_ship) x
    about 40 distinct users, over 10 blocks of 256 rows."""
    d = str(tmp_path_factory.mktemp("hllesc"))
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 256
    try:
        n = 2400
        RefTable("hllesc", RefFlags(dir=d, table="hllesc",
                                    skip_compact=True)).ingest_columns(
            ints={"time": np.arange(n, dtype=np.int64)},
            strs={"g": [f"g{i % 20}" for i in range(n)],
                  "u": [f"user{i % 800}" for i in range(n)]})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


@pytest.mark.parametrize("batch", [1, 4])
def test_distinct_device_hll_multibatch_and_escalation(hllesc, batch):
    """tests/test_query_engine.py:240: planes merge by max across
    batches, and live groups past hll_ship escalate to the full planes."""
    flags = Flags(dir=hllesc, table="hllesc", device="cpu",
                  device_batch=batch)
    params = QueryParams(groups=("g",), distincts=("u",))
    t = Table("hllesc", flags)
    t.load_info()
    assert BoundQuery(t, params, flags).config.hll
    want, got = _both(hllesc, "hllesc", batch, groups=("g",),
                      distincts=("u",))
    assert len(got.results) == 20
    assert _cardinalities(got) == _cardinalities(want)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """17,000 rows of unique ints in one batch: more (group, distinct)
    pairs than the packed section's 16,384 rows."""
    d = str(tmp_path_factory.mktemp("wide"))
    rng = np.random.default_rng(5)
    n = 17000
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 4096
    try:
        RefTable("wide", RefFlags(dir=d, table="wide",
                                  skip_compact=True)).ingest_columns(
            ints={"u": np.arange(n, dtype=np.int64) * 7,
                  "g": rng.integers(0, 3000, n)},
            strs={"h": [HOSTS[i] for i in rng.integers(0, 5, n)]})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


def _cli(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


# name -> (table fixture, table, CLI arguments)
CLI_QUERIES = {
    "hll-str": ("uptime", "uptime", ["-group", "host", "-distinct",
                                     "status"]),
    "hll-int": ("uptime", "uptime", ["-group", "host", "-distinct",
                                     "index_int"]),
    "hll-time-bucketed": ("uptime", "uptime",
                          ["-time", "-time-bucket", "21600", "-group",
                           "status", "-distinct", "host"]),
    "pairs-d2": ("uptime", "uptime", ["-group", "host", "-distinct",
                                      "status,ping"]),
    "pairs-op-distinct": ("uptime", "uptime", ["-group", "host,status",
                                               "-op", "distinct"]),
    "pairs-int-groups": ("uptime", "uptime", ["-group", "ping", "-distinct",
                                              "host"]),
    "pairs-escalation": ("wide", "wide", ["-group", "g", "-distinct", "u",
                                          "-device-batch", "8"]),
    "hll-escalation": ("hllesc", "hllesc", ["-group", "g", "-distinct",
                                            "u"]),
}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("name", sorted(CLI_QUERIES))
def test_distinct_cli_matches_reference_bytes(request, name, fmt):
    fixture, table, argv = CLI_QUERIES[name]
    d = request.getfixturevalue(fixture)
    ints = {"uptime": "ping", "wide": "u", "hllesc": "time"}[table]
    base = ["query", "-dir", d, "-table", table, "-int", ints, *argv]
    if fmt == "json":
        base.append("-json")
    want = _cli(ref_cli.main, base)
    assert want[0] == 0
    assert _cli(port_cli.main, base + ["-device", "cpu"]) == want


def test_distinct_limit_early_exit(tmp_path):
    """tests/test_query_features.py:119, and with a distinct column: the
    scan stops once the group count reaches -distinct-limit."""
    old = port_digest.CHUNK_SIZE
    port_digest.CHUNK_SIZE = 512
    try:
        n = 4096
        Table("t", Flags(dir=str(tmp_path), table="t",
                         skip_compact=True)).ingest_columns(
            ints={"uid": np.arange(n, dtype=np.int64) // 512,
                  "time": np.arange(n, dtype=np.int64)})
    finally:
        port_digest.CHUNK_SIZE = old
    d = str(tmp_path)
    for extra in ({}, {"distincts": ("time",)}):
        full, got_full = _both(d, "t", 1, groups=("uid",), **extra)
        assert len(got_full.results) == len(full.results) == 8
        want, got = _both(d, "t", 1, groups=("uid",), num_distinct=2,
                          **extra)
        assert 2 <= len(got.results) < 8
        assert _cardinalities(got) == _cardinalities(want)
