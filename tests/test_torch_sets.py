"""Set filters (in / nin over set columns) in the port against the JAX
reference, on the CPU.

Batch level: the same seeded numpy batch and set-column CSR, padded the
way the engines' loaders pad it (block rows offset by bi * C, a power of
two of entries, pads at row R with value -2), go through
sybil_tpu.ops.scan.scan_packed_jit and sybil_tpu_torch.ops.scan.scan_packed
(K14's plain version, then K2's, K7's or the enumerated strategy's): the
packed buffers must agree word for word.  Query level: tables written by
sybil_tpu, queried by both engines; results and printed bytes equal."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sybil_tpu.digest as ref_digest
from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.digest import digest_records
from sybil_tpu.ingest import flatten_record
from sybil_tpu.ops import scan as ref
from sybil_tpu.query import engine as ref_engine
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import FilterDef as RefFilter
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import blocks as port_blocks
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import residency
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query import engine as port_engine
from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
from sybil_tpu_torch.table import Table

B, C = 3, 1024
R = B * C


# ---------------------------------------------------------------------------
# batch level
# ---------------------------------------------------------------------------

def set_rows(rng, n_vals: int = 8):
    """Per row of the batch, a set of value ids: a fifth empty, some with
    the same value twice, row R-1 holding value 3 twice."""
    lists = []
    for _ in range(R):
        k = rng.choice([0, 1, 2, 3], p=[0.2, 0.4, 0.25, 0.15])
        lists.append([int(x) for x in rng.integers(0, n_vals, k)])
    lists[R - 1] = [3, 3]
    return lists


def batch_csr(lists, nrec=None, empty=False):
    """The loaders' batch CSR of per-row lists: each block's rows (those
    of a block with records) in order, padded to a power of two (at least
    128) with row R and value -2.  -> (prow int32, pval int64, n)."""
    rows, vals = [], []
    for bi in range(B):
        if empty or (nrec is not None and not nrec[bi]):
            continue
        for r in range(bi * C, (bi + 1) * C):
            rows += [r] * len(lists[r])
            vals += lists[r]
    prow, pval = port_engine.pad_set_csr(rows, vals, R)
    return prow, pval, len(rows)


def set_match_numpy(lists, fv):
    """(has, hit) bool [R] of per-row lists against constant fv."""
    has = np.array([len(x) > 0 for x in lists])
    hit = np.array([fv in x for x in lists])
    return has, hit


# name -> options: strategy (dense, sorted, enum); filters (col, op, kind,
# constant; set columns s0, s1); nrec; empty (an all-pad CSR); count
# (a set-only query: no keys, no aggregations)
SET_CASES = {
    "dense-in": dict(filters=[("s0", "in", "set", 3)]),
    "dense-nin": dict(filters=[("s0", "nin", "set", 3)]),
    "dense-in-unknown": dict(filters=[("s0", "in", "set", -1)]),
    "dense-nin-unknown": dict(filters=[("s0", "nin", "set", -1)]),
    "dense-empty-csr": dict(filters=[("s0", "nin", "set", 3)], empty=True),
    "dense-rows-past-nrec": dict(filters=[("s0", "in", "set", 5)],
                                 nrec=(0, 700, 1)),
    "dense-two-on-one-column": dict(filters=[("s0", "in", "set", 2),
                                             ("s0", "nin", "set", 4)]),
    "dense-mixed-filters": dict(filters=[("fi", "gt", "int", 20),
                                         ("s1", "in", "set", 1),
                                         ("fs", "neq", "str", 4),
                                         ("fs", "re", "str", 0),
                                         ("s0", "nin", "set", 6)]),
    "dense-set-only": dict(filters=[("s0", "in", "set", 3)], count=True),
    "sorted-in": dict(strategy="sorted", filters=[("s0", "in", "set", 3)]),
    "sorted-nin-mixed": dict(strategy="sorted",
                             filters=[("fi", "lt", "int", 60),
                                      ("s0", "nin", "set", 1),
                                      ("s1", "in", "set", 0)]),
    "sorted-unknown-empty": dict(strategy="sorted",
                                 filters=[("s0", "nin", "set", -1)],
                                 empty=True),
    "enum-in": dict(strategy="enum", filters=[("s0", "in", "set", 3)]),
    "enum-two-on-one-column": dict(strategy="enum",
                                   filters=[("s0", "in", "set", 1),
                                            ("s0", "nin", "set", 2),
                                            ("fs", "neq", "str", 4)]),
}


def make_set_case(name):
    """-> (reference ScanConfig, cols, nrec, filter constants, bitsets,
    set lists by column, ref set_aux, port set_aux)."""
    o = SET_CASES[name]
    rng = np.random.default_rng(700 + sorted(SET_CASES).index(name))
    strategy = o.get("strategy", "dense")
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    groups, bounds, aggs = (), (), ()
    if not o.get("count"):
        if strategy == "enum":
            put("k0", rng.integers(3, 83, R), 0.8)
            bounds = ((3, 80),)
        else:
            put("k0", rng.integers(0, 5, R), 0.9)
            bounds = ((0, 5),)
        groups = ("k0",)
        put("v0", rng.integers(-10, 120, R), 0.85)
        aggs = (ref.AggSpec("v0", hist_min=0, bucket_size=0, num_values=0,
                            discard_min=0, discard_max=100),)
    else:
        cols["__count__"] = (np.zeros((B, C), np.int64),
                             np.ones((B, C), bool))
    filters, fvals = [], []
    sets = {}
    for col, op, kind, val in o["filters"]:
        if kind == "set":
            if col not in sets:
                sets[col] = set_rows(rng)
        elif col not in cols:
            put(col, rng.integers(0, 80 if col == "fi" else 10, R), 0.9)
        filters.append(ref.FilterSpec(col, op, kind,
                                      0 if op in ("re", "nre") else -1))
        fvals.append(val)
    bits = (np.array([i % 3 != 0 for i in range(10)]),)
    kw = {}
    if strategy == "sorted":
        kw = dict(force_sorted=True)
    elif strategy == "enum":
        kw = dict(sort_pack=bounds, prune_topk=25, prune_agg=-1,
                  force_sorted=True)
    cfg = ref.ScanConfig(group_cols=groups, aggs=aggs,
                         filters=tuple(filters),
                         key_bounds=bounds if strategy != "sorted" else (),
                         **kw)
    nrec = np.array(o.get("nrec", (C, C - 300, C - 3)), np.int32)
    ref_aux, port_aux = {}, {}
    for col, lists in sets.items():
        prow, pval, n = batch_csr(lists, nrec, o.get("empty", False))
        ref_aux[col] = (jnp.asarray(prow), jnp.asarray(pval))
        port_aux[col] = (torch.from_numpy(prow), torch.from_numpy(pval), n)
    return (cfg, cols, nrec, np.asarray(fvals, np.int64), bits, sets,
            ref_aux, port_aux)


def run_set_case(name):
    cfg, cols, nrec, fvals, bits, sets, ref_aux, port_aux = \
        make_set_case(name)
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(1, jnp.int64),
        ref_aux)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), tuple(torch.from_numpy(b) for b in bits),
        1, port_aux)
    return cfg, pcfg, packed, out, ppacked, raw


@pytest.mark.parametrize("name", sorted(SET_CASES))
def test_set_filter_scan_matches_reference(name):
    cfg, pcfg, packed, _, ppacked, raw = run_set_case(name)
    strategy = SET_CASES[name].get("strategy", "dense")
    assert pcfg.strategy == cfg.strategy
    assert (port.enum_radix(pcfg) > 0) == (strategy == "enum")
    assert (pcfg.strategy == "dense") == (strategy == "dense")
    want = np.asarray(packed["main"])
    got = ppacked["main"].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if strategy != "dense":
        np.testing.assert_array_equal(ppacked["table"].numpy(),
                                      np.asarray(packed["table"]))
    # the matched rows, through the group counts or the enum totals,
    # against numpy
    if strategy == "enum":
        matched = int(want[0, 6])
    elif strategy == "sorted":
        ng = int(want[0, 0])
        matched = int(want[1: 1 + ng, pcfg.n_key_cols + 1].sum())
    else:
        matched = int(raw["sums"][:, 1].sum())
    want_n = int(matched_numpy(name).sum())
    assert matched == want_n
    assert (want_n == 0) == (name in ("dense-in-unknown", "dense-empty-csr",
                                      "sorted-unknown-empty"))


def matched_numpy(name):
    """The front end's matched rows of a case, in numpy."""
    cfg, cols, nrec, fvals, bits, sets, _, _ = make_set_case(name)
    o = SET_CASES[name]
    ok = (np.arange(C)[None, :] < nrec[:, None]).reshape(R)
    for f, fv in zip(cfg.filters, fvals):
        if f.kind == "set":
            lists = sets[f.col]
            if o.get("empty"):
                lists = [[] for _ in lists]
            has, hit = set_match_numpy(lists, fv)
            for bi in range(B):
                if not nrec[bi]:        # the loader leaves the block out
                    has[bi * C:(bi + 1) * C] = False
            ok &= has & (hit if f.op == "in" else ~hit)
            continue
        v, m = (x.reshape(R) for x in cols[f.col])
        if f.op == "gt":
            ok &= m & (v > fv)
        elif f.op == "lt":
            ok &= m & (v < fv)
        elif f.op == "neq":
            ok &= m & (v != fv)
        elif f.op == "re":
            ok &= m & bits[0][np.clip(v, 0, len(bits[0]) - 1)]
    return ok


@pytest.mark.parametrize("fv", [3, 0, -1, 7])
def test_set_match_plain_bitmasks(fv):
    """K14's plain version: the has and hit bits of every row, against
    Python sets; duplicates, empty rows, row R-1 and rows of a block
    with no records (whose entries the loader leaves out)."""
    rng = np.random.default_rng(31 + fv)
    lists = set_rows(rng)
    nrec = np.array([C, 0, 5], np.int32)
    prow, pval, n = batch_csr(lists, nrec)
    fvals = torch.tensor([99, fv], dtype=torch.int64)
    has_w, hit_w = port.set_match(torch.from_numpy(prow),
                                  torch.from_numpy(pval), n, fvals, 1, R)
    assert has_w.dtype == torch.int32 and has_w.shape == (port.mask_words(R),)
    has = port.unpack_row_bits(has_w, R).numpy()
    hit = port.unpack_row_bits(hit_w, R).numpy()
    want_has, want_hit = set_match_numpy(lists, fv)
    want_has[C: 2 * C] = want_hit[C: 2 * C] = False     # block 1 left out
    np.testing.assert_array_equal(has, want_has)
    np.testing.assert_array_equal(hit, want_hit)
    assert hit[R - 1] == (fv == 3) and has[R - 1]
    np.testing.assert_array_equal(
        port.pack_row_bits(torch.from_numpy(want_hit), R), hit_w)


def test_set_match_all_pad_csr():
    prow, pval, n = batch_csr(None, empty=True)
    assert n == 0 and len(prow) == 128
    has, hit = port.set_match(torch.from_numpy(prow), torch.from_numpy(pval),
                              n, torch.tensor([-2]), 0, R)
    assert not has.any() and not hit.any()


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]


def uptime_columns(n: int, seed: int, start: int = 0):
    """scripts/fakedata/host_generator.py's columns at a fixed time: the
    `groups` set holds mod2, mod3, mod5 of index_int, or `none`."""
    rng = np.random.default_rng(seed + start)
    idx = np.arange(start, start + n, dtype=np.int64)
    ints = {"ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
            "weight": rng.choice([1, 10, 100], n).astype(np.int64),
            "time": 1_755_000_000 + rng.integers(-2419200, 2419200, n),
            "index_int": idx}
    strs = {"status": [STATII[i] for i in rng.integers(0, 5, n)],
            "host": [HOSTS[i] for i in rng.integers(0, 5, n)]}
    sets = {"groups": [[g for m, g in ((2, "mod2"), (3, "mod3"), (5, "mod5"))
                        if i % m == 0] or ["none"] for i in idx.tolist()]}
    return ints, strs, sets


@pytest.fixture(scope="module")
def uptime_sets(tmp_path_factory):
    """2,500 uptime rows with `groups`, 512-row blocks, two ingests."""
    d = str(tmp_path_factory.mktemp("upsets"))
    t = RefTable("uptime", RefFlags(dir=d, table="uptime", skip_compact=True))
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 512
    try:
        for start, n in ((0, 1300), (1300, 1200)):
            ints, strs, sets = uptime_columns(n, 1337, start)
            t.ingest_columns(ints=ints, strs=strs, sets=sets)
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """tests/test_reference_goldens.py's table: 3 blocks of 100 records
    {id, age in [10, 29], age_str, age_set = [age_str]}, from records
    through the row store and a digest."""
    import random
    d = str(tmp_path_factory.mktemp("golden"))
    flags = RefFlags(dir=d, table="golden", skip_compact=True,
                     device_batch=3)
    t = RefTable("golden", flags)
    rng = random.Random(1234)
    recs = []
    for i in range(300):
        age = rng.randrange(20) + 10
        recs.append(flatten_record({"id": i, "age": age, "age_str": str(age),
                                    "age_set": [str(age)]}))
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 100
    try:
        t.ingest_records(recs)
        digest_records(t)
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


def state(qr):
    return ({k: (tuple(r.key_tuple), r.count, r.samples,
                 {c: (h.count, h.avg, h.min, h.max)
                  for c, h in r.hists.items()})
             for k, r in qr.results.items()},
            (qr.cumulative.count, qr.cumulative.samples), qr.matched_count,
            [r.group_key for r in qr.sorted])


def run_both(d, table, groups=(), aggs=(), filters=(), batch=16, op="avg",
             htype="basic", **kw):
    want = ref_engine.run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        RefParams(groups=groups, aggs=tuple(RefAgg(a, op, htype)
                                            for a in aggs),
                  filters=tuple(RefFilter(*f) for f in filters), **kw),
        RefFlags(dir=d, table=table, device_batch=batch))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=batch)
    got = port_engine.run_query(
        Table(table, flags),
        QueryParams(groups=groups, aggs=tuple(AggDef(a, op, htype)
                                              for a in aggs),
                    filters=tuple(FilterDef(*f) for f in filters), **kw),
        flags)
    return got, want


@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("op", ["in", "nin"])
def test_set_filters_group_by_host(uptime_sets, op, batch):
    """tests/test_query_engine.py:138: groups in / nin mod3 by host."""
    got, want = run_both(uptime_sets, "uptime", ("host",), ("ping",),
                         (("groups", op, "mod3", "set"),), batch)
    assert state(got) == state(want)
    n = sum(r.count for r in got.results.values())
    assert n == (834 if op == "in" else 1666)      # index_int % 3 == 0


@pytest.mark.parametrize("value,ngroups", [("in", 1), ("nin", 19)])
def test_golden_set_in_nin(golden, value, ngroups):
    """tests/test_reference_goldens.py:246-304 (Go's testSetIn and
    testSetNin): age_set in / nin "20", grouped by age."""
    got, want = run_both(golden, "golden", ("age",), ("age",),
                         (("age_set", value, "20", "set"),), 3)
    assert state(got) == state(want)
    assert len(got.results) == ngroups
    for r in got.results.values():
        assert (r.hists["age"].mean() == 20) == (value == "in")


def cli_out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["text", "-json"])
@pytest.mark.parametrize("argv", [
    ["-group", "host", "-int", "ping", "-set-filter", "groups:in:mod3"],
    ["-group", "host", "-int", "ping", "-set-filter", "groups:nin:mod2",
     "-str-filter", "status:eq:200"],
    ["-group", "host,status", "-int", "ping", "-op", "hist", "-tdigest",
     "-set-filter", "groups:in:mod5"],
    ["-set-filter", "groups:in:nosuch"],
    ["-set-filter", "groups:nin:nosuch,groups:in:mod2", "-int", "ping",
     "-op", "hist"],
], ids=["S1", "S2", "S3-sorted", "S5-in-unknown", "nin-unknown-and-in"])
def test_set_filter_cli_bytes_match_reference(uptime_sets, argv, fmt,
                                              capsys):
    base = ["query", "-dir", uptime_sets, "-table", "uptime", *argv]
    if fmt == "-json":
        base.append("-json")
    want = cli_out(ref_cli.main, base, capsys)
    assert cli_out(port_cli.main, base + ["-device", "cpu"], capsys) == want
    if fmt == "-json" and "-tdigest" in argv:
        assert len(json.loads(want)) > 5


def test_warm_set_query_reads_no_set_file(uptime_sets, monkeypatch):
    """tests/test_query_features.py:463: the second run of a set-filter
    query re-reads no set file and rebuilds no CSR (both stay resident)."""
    flags = Flags(dir=uptime_sets, table="uptime", device="cpu",
                  device_batch=16)
    t = Table("uptime", flags)
    params = QueryParams(groups=("host",), filters=(
        FilterDef("groups", "in", "mod5", "set"),))
    residency.CACHE.clear()
    first = port_engine.run_query(t, params, flags)
    calls = []
    real = port_blocks.load_block_columns

    def spy(bdir, schema, cols):
        calls.append(tuple(cols))
        return real(bdir, schema, cols)

    monkeypatch.setattr(port_blocks, "load_block_columns", spy)
    misses = residency.CACHE.misses
    second = port_engine.run_query(t, params, flags)
    assert [c for c in calls if "groups" in c] == []
    assert residency.CACHE.misses == misses
    a = {k: r.count for k, r in first.results.items()}
    assert a == {k: r.count for k, r in second.results.items()}
    assert sum(a.values()) == 500


def test_changed_block_probe_on_set_cache_hit(uptime_sets, monkeypatch):
    """A set-only query's one staleness probe sits in the set-batch
    cache hit: a block whose record count changed after the info
    snapshot is skipped on a warm run too, as the reference skips it."""
    flags = Flags(dir=uptime_sets, table="uptime", device="cpu",
                  device_batch=16)
    t = Table("uptime", flags)
    params = QueryParams(filters=(FilterDef("groups", "nin", "mod2",
                                            "set"),))
    residency.CACHE.clear()
    full = port_engine.run_query(t, params, flags)
    assert full.cumulative.count == 1250
    infos = t.block_infos()
    first = sorted(infos)[0]
    real = Table.block_infos

    def stale(self):
        out = real(self)
        info = out[first]
        out[first] = dataclasses.replace(info,
                                         num_records=info.num_records - 1)
        return out

    monkeypatch.setattr(Table, "block_infos", stale)
    qr = port_engine.run_query(t, params, flags)
    monkeypatch.setattr(Table, "block_infos", real)
    idx = port_blocks.load_block_columns(first, t.schema,
                                         ["index_int"])["index_int"].values
    assert 0 < int((idx % 2).sum()) < 1250
    assert qr.cumulative.count == 1250 - int((idx % 2).sum())


# the enumerated strategy with a set filter, at tests/test_torch_enum.py's
# config 5 shape: userid ~ Zipf(1.2) as person{u} plus a tail of users
# seen once, 28 blocks of 512 rows, and a `tags` set per row
def zipf_tags(d: str):
    rng = np.random.default_rng(1900)
    uid = np.concatenate([rng.zipf(1.2, 7000) % 200_000,
                          310_000 + np.arange(7000)])
    rng.shuffle(uid)
    n = len(uid)
    tags = [[t for t, p in (("a", 0.5), ("b", 0.3), ("c", 0.1))
             if u < p] for u in rng.random(n)]
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 512
    try:
        RefTable("sessions_zipf", RefFlags(
            dir=d, table="sessions_zipf", skip_compact=True)).ingest_columns(
            ints={"weight": rng.choice([1, 10, 100], n).astype(np.int64)},
            strs={"userid": [f"person{u}" for u in uid]},
            sets={"tags": tags}, valid={"weight": rng.random(n) > 0.1})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


@pytest.mark.parametrize("flt", [("tags", "in", "a", "set"),
                                 ("tags", "nin", "b", "set")])
def test_enum_strategy_with_set_filter(tmp_path, flt, monkeypatch):
    d = zipf_tags(str(tmp_path))
    seen = []
    real = port.scan_packed

    def spy(cfg, *a, **k):
        seen.append(cfg)
        return real(cfg, *a, **k)

    monkeypatch.setattr(port, "scan_packed", spy)
    got, want = run_both(d, "sessions_zipf", ("userid",), ("weight",),
                         (flt,), 4, limit=5, prune_by="$COUNT")
    assert seen and all(port.enum_radix(c) > 0 for c in seen)
    assert state(got) == state(want)
    assert 0 < got.matched_count < 14_000
    assert got.matched_count == got.cumulative.samples


def test_set_only_query_counts(uptime_sets):
    """A bare set-filter count: the loader's __count__ lane scans."""
    got, want = run_both(uptime_sets, "uptime",
                         filters=(("groups", "in", "mod2", "set"),
                                  ("groups", "nin", "mod3", "set")))
    assert state(got) == state(want)
    assert got.cumulative.count == sum(1 for i in range(2500)
                                       if i % 2 == 0 and i % 3)


def test_port_written_set_table_reads_back(tmp_path):
    """The port's own ingest of a set column: the reference reads the
    same answers from it."""
    d = str(tmp_path)
    ints, strs, sets = uptime_columns(700, 5)
    Table("uptime", Flags(dir=d, table="uptime", skip_compact=True)
          ).ingest_columns(ints=ints, strs=strs, sets=sets)
    got, want = run_both(d, "uptime", ("status",), ("ping",),
                         (("groups", "in", "mod5", "set"),))
    assert state(got) == state(want)
    assert got.cumulative.count == 140


def test_block_without_the_set_column(tmp_path):
    """A block written before the set column existed holds no entries:
    neither in nor nin passes its rows.  This departs from the reference
    on purpose: it raises on such a block, reading the offsets of a
    column it did not find, and the test pins that too."""
    d = str(tmp_path)
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 100
    try:
        t = RefTable("t", RefFlags(dir=d, table="t", skip_compact=True))
        t.ingest_columns(ints={"v": np.arange(100)})
        t.ingest_columns(ints={"v": np.arange(100, 250)},
                         sets={"s": [["a"] if i % 2 else ["b"]
                                     for i in range(150)]})
    finally:
        ref_digest.CHUNK_SIZE = old
    for op in ("in", "nin"):
        with pytest.raises(AttributeError, match="offsets"):
            ref_engine.run_query(
                RefTable("t", RefFlags(dir=d, table="t")),
                RefParams(aggs=(RefAgg("v", "avg"),),
                          filters=(RefFilter("s", op, "a", "set"),)),
                RefFlags(dir=d, table="t"))
    flags = Flags(dir=d, table="t", device="cpu")
    for op, want in (("in", 75), ("nin", 75)):
        qr = port_engine.run_query(Table("t", flags), QueryParams(
            aggs=(AggDef("v", "avg"),),
            filters=(FilterDef("s", op, "a", "set"),)), flags)
        assert qr.cumulative.count == want
        vals = [100 + i for i in range(150) if (i % 2 == 1) == (op == "in")]
        assert qr.cumulative.hists["v"].mean() == sum(vals) / len(vals)
