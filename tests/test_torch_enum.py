"""Port of the enumerated strategy (K7's enum form, K11, K12, K10's enum
and prune forms, plain versions), the sorted strategy's device prune, the
engine's pruned downloads and the node protocol (-encode-results,
aggregate), against the JAX reference.

Scan level: the same numpy batch goes through sybil_tpu.ops.scan.
scan_packed_jit and sybil_tpu_torch.ops.scan.scan_packed (CPU tensors);
the packed `main` buffer and the returned table must agree word for
word, under both of the reference's enum forms (bit-packed carriers from
lane_row_bounds, and the idx-and-gather fallback without them).  The
plain top-k is held against _topk_rows and lax.top_k index for index.

Query level: tables of more than 16 small blocks, so the engine asks for
the device prune; run_query's results and the CLI's printed bytes (text
and -json) must equal the reference's, as must each node's
-encode-results output and `aggregate` over two nodes' results.  Every
compared value is an integer, a bool, printed text or an f32 the two
packages compute by the same steps: equality is exact."""

import dataclasses
import io
import json
import os
import sys

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
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.query import engine as port_engine
from sybil_tpu_torch.query.spec import AggDef, QueryParams
from sybil_tpu_torch.table import Table

B, C = 3, 1024

# name -> options.  keys: [(lo, hi) of the values, (min, card) bound];
# aggs: [(lo, hi) of the values, discard (min, max)]; weight; vbias (bias
# = each agg's discard min); prune: (prune_topk, prune_agg); filters
# (col, op, kind, constant); nrec: per-block records; extra: ScanConfig
# fields.  Enumerated unless "sorted" (the device prune on the sorted
# strategy: unpacked keys, or a time key)
CASES = {
    # heavy-tailed keys: ties of equal counts cross the k boundary
    "count-ties-across-k": dict(keys=[((0, 400), (0, 400))],
                                aggs=[((0, 90), (0, 100))], prune=(20, -1),
                                zipf=1.3),
    "count-weight": dict(keys=[((0, 300), (0, 300))],
                         aggs=[((0, 90), (0, 100))], weight=True,
                         prune=(50, -1)),
    "mean-vbias-negative": dict(keys=[((0, 200), (0, 200))],
                                aggs=[((-500, -100), (-450, -120))],
                                vbias=True, prune=(30, 0)),
    "mean-weight-two-aggs": dict(keys=[((0, 120), (0, 120))],
                                 aggs=[((0, 50), (0, 60)),
                                       ((-40, 900), (-30, 800))],
                                 weight=True, vbias=True, prune=(40, 1)),
    "fewer-live-than-k": dict(keys=[((0, 6), (0, 6))],
                              aggs=[((0, 90), (0, 100))], prune=(100, -1)),
    "r-below-prefix": dict(keys=[((0, 30), (0, 30))],
                           aggs=[((0, 90), (0, 100))], prune=(1000, -1),
                           shape=(1, 64)),
    "packed-spill": dict(keys=[((0, 60), (0, 50)), ((0, 4), (0, 4))],
                         aggs=[((0, 90), (0, 100))], prune=(30, -1)),
    "filters-missing-keys": dict(keys=[((3, 83), (3, 80))],
                                 aggs=[((0, 90), (0, 100))], prune=(25, -1),
                                 vbias=True, p_valid=0.7,
                                 filters=[("fi", "gt", "int", 10),
                                          ("fs", "neq", "str", 4),
                                          ("fs", "re", "str", 0)]),
    "two-keys": dict(keys=[((0, 40), (0, 40)), ((2, 11), (2, 9))],
                     aggs=[((0, 90), (0, 100))], weight=True,
                     prune=(60, -1)),
    "all-unmatched": dict(keys=[((0, 50), (0, 50))],
                          aggs=[((0, 90), (0, 100))], prune=(20, 0),
                          nrec=(0, 0, 0)),
    # the sorted strategy's device prune
    "sorted-unpacked": dict(keys=[((-5, 300), None), ((0, 3), None)],
                            aggs=[((0, 90), (0, 100))], prune=(40, -1),
                            zipf=1.4, sorted=True),
    "sorted-time-key": dict(keys=[((0, 5), None)], aggs=[((0, 90), (0, 100))],
                            time=(-40_000, 90_000, 100), prune=(30, -1),
                            sorted=True),
    "sorted-mean": dict(keys=[((0, 300), None)],
                        aggs=[((-300, 400), (-250, 350))], prune=(25, 0),
                        weight=True, sorted=True),
    "sorted-table-ties": dict(keys=[((0, 500), None)],
                              aggs=[((0, 90), (0, 100))], prune=(16, -1),
                              sorted=True),
    "sorted-group-cap": dict(keys=[((0, 400), None)],
                             aggs=[((0, 90), (0, 100))], prune=(1000, -1),
                             weight=True, sorted=True,
                             extra=dict(max_groups=60)),
}
ENUM_CASES = sorted(k for k, o in CASES.items() if not o.get("sorted"))
SORTED_CASES = sorted(k for k, o in CASES.items() if o.get("sorted"))


def _make(name, form="carry"):
    """-> (reference ScanConfig, {col: (values, valid)}, nrec, filter
    constants, regex bitsets, time bucket)."""
    o = CASES[name]
    Bn, Cn = o.get("shape", (B, C))
    R = Bn * Cn
    rng = np.random.default_rng(5000 + sorted(CASES).index(name))
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(Bn, Cn),
                     (rng.random(R) < p_valid).reshape(Bn, Cn))

    groups, pack = [], []
    for i, ((lo, hi), pb) in enumerate(o["keys"]):
        if o.get("zipf"):
            v = lo + (rng.zipf(o["zipf"], R) - 1) % (hi - lo)
        else:
            v = rng.integers(lo, hi, R)
        put(f"k{i}", v, o.get("p_valid", 0.9))
        groups.append(f"k{i}")
        pack.append(pb)
    tkw, tb = {}, 1
    if "time" in o:
        lo, hi, tb = o["time"]
        put("t", rng.integers(lo, hi, R), 0.95)
        tkw = dict(time_col="t")
    aggs = []
    for a, ((lo, hi), (dmin, dmax)) in enumerate(o["aggs"]):
        put(f"v{a}", rng.integers(lo, hi, R), 0.85)
        aggs.append(ref.AggSpec(f"v{a}", hist_min=dmin, bucket_size=0,
                                num_values=0, discard_min=dmin,
                                discard_max=dmax))
    filters, fvals = [], []
    for col, op, kind, val in o.get("filters", ()):
        if col not in cols:
            put(col, rng.integers(0, 80 if col == "fi" else 10, R), 0.9)
        filters.append(ref.FilterSpec(col, op, kind,
                                      0 if op in ("re", "nre") else -1))
        fvals.append(val)
    bits = (np.array([i % 3 != 0 for i in range(10)]),)
    wmax = 1
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
        wmax = 100
    vbias = tuple(a.discard_min for a in aggs) if o.get("vbias") else ()
    rb = ()
    if form == "carry":
        # exact per-row lane bounds, as the bind derives them
        rb = [wmax, 1]
        for a, bias in zip(aggs, vbias or (0,) * len(aggs)):
            rb += [1, wmax, wmax * (a.discard_max - bias)]
        rb = tuple(rb)
    prune_topk, prune_agg = o["prune"]
    cfg = ref.ScanConfig(
        group_cols=tuple(groups), aggs=tuple(aggs), filters=tuple(filters),
        weight_col="w" if o.get("weight") else "",
        sort_pack=() if o.get("sorted") else tuple(pack),
        key_bounds=() if o.get("sorted") else tuple(pack),
        agg_vbias=vbias, lane_row_bounds=rb, prune_topk=prune_topk,
        prune_agg=prune_agg, **tkw, **o.get("extra", {}))
    if not o.get("sorted") and cfg.dense_slots:
        cfg = dataclasses.replace(cfg, force_sorted=True)
    nrec = np.array(o.get("nrec", [Cn, Cn - 300, Cn - 3][:Bn]), np.int32)
    return cfg, cols, nrec, np.asarray(fvals, np.int64), bits, tb


def _run_both(name, form="carry"):
    cfg, cols, nrec, fvals, bits, tb = _make(name, form)
    packed, _ = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(tb, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, _ = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), tuple(torch.from_numpy(b) for b in bits),
        tb)
    return cfg, pcfg, packed, ppacked


@pytest.mark.parametrize("form", ["carry", "gather"])
@pytest.mark.parametrize("name", ENUM_CASES)
def test_enum_scan_matches_reference(name, form):
    cfg, pcfg, packed, ppacked = _run_both(name, form)
    R = B * C if "shape" not in CASES[name] else int(np.prod(
        CASES[name]["shape"]))
    radix = port.enum_radix(pcfg)
    assert radix == ref.enum_radix(cfg) > 0
    L = 2 + 3 * len(pcfg.aggs)
    plan, _ = ref._enum_carry_plan(cfg, L, R)
    assert (plan is not None) == (form == "carry")
    want = np.asarray(packed["main"])
    got = ppacked["main"].numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ppacked["table"].numpy(),
                                  np.asarray(packed["table"]))
    # each case reaches the edge it is named for
    meta = want[0]
    P = port.table_prefix(pcfg)
    assert meta[4] == P                        # the pruned marker
    assert (meta[1] > 0) == (name == "packed-spill")
    live = int((want[1:, 0] != port.SENTINEL).sum())
    if name == "all-unmatched":
        assert meta[0] == 0 and live == 0 and meta[5] == meta[6] == 0
    elif name in ("fewer-live-than-k", "r-below-prefix"):
        assert 0 < meta[0] < P and live == meta[0]
    else:
        assert meta[0] > P and live == P
    if name == "count-ties-across-k":
        counts = want[1:, 1]
        assert (np.sort(np.asarray(packed["table"])[:, 1]) ==
                counts[-1]).sum() >= 1 and len(set(counts.tolist())) < P
    if name == "filters-missing-keys":
        assert (want[1:, 0] == port.MISSING).any()


# chip_smoke.py's K11 cases in both of the reference's enum forms, but the
# carry form of the wrapping sums: their lanes have no bound to pack
K11_FORMS = [(name, form) for name in chip_smoke.K11_CASES
             for form in ("carry", "gather")
             if not (form == "carry" and name == "sums that wrap mod 2^64")]


@pytest.mark.parametrize("name,form", K11_FORMS)
def test_k11_case_matches_reference(name, form):
    """K11 on chip_smoke.py's K11 cases (the card holds the kernel to its
    plain version on the same cases at 196,608 rows and more): the port's
    scan_packed (K7's enum form, the sort, K11, K12, K10's enum_pack,
    plain) against the reference's scan_packed_jit on the same batch, made
    smaller, main and table word for word; and K11's plain outputs reach
    the case's edge."""
    Bk, Ck = 2, 2048
    fields, cols, nrec = chip_smoke.k11_case(name, Bk, Ck)
    o = dict(fields)
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o["aggs"])
    if form == "carry":
        # exact per-row lane bounds, as the bind derives them
        lo, hi = chip_smoke.K11_CASES[name].get("weight", (1, 2))
        wmax = hi - 1
        assert lo >= 0
        rb = [wmax, 1]
        for a, bias in zip(o["aggs"], o["agg_vbias"] or (0,) * len(o["aggs"])):
            rb += [1, wmax, wmax * (a.discard_max - bias)]
        o["lane_row_bounds"] = tuple(rb)
    cfg = ref.ScanConfig(**o)
    L = 2 + 3 * len(cfg.aggs)
    plan, _ = ref._enum_carry_plan(cfg, L, Bk * Ck)
    assert (plan is not None) == (form == "carry")
    fv = np.zeros(0, np.int64)
    packed, _ = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fv), (), jnp.asarray(1, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    assert port.enum_radix(pcfg) == ref.enum_radix(cfg) > 0
    tcols = {k: (torch.from_numpy(v), torch.from_numpy(m))
             for k, (v, m) in cols.items()}
    ppacked, _ = port.scan_packed(pcfg, tcols, torch.from_numpy(nrec),
                                  torch.from_numpy(fv), (), 1)
    np.testing.assert_array_equal(ppacked["main"].numpy(),
                                  np.asarray(packed["main"]))
    np.testing.assert_array_equal(ppacked["table"].numpy(),
                                  np.asarray(packed["table"]))
    front = port.sorted_front_plain(pcfg, tcols, torch.from_numpy(nrec),
                                    torch.from_numpy(fv), ())
    skey, p = torch.sort(front["key"], stable=True)
    # 48: a range length at which each case reaches its edge at this size
    chip_smoke.k11_case_expect(name, Bk * Ck, 48,
                               port.enum_segments_plain(pcfg, tcols, skey, p))


@pytest.mark.parametrize("R", [4, 128, 40_960, 196_608, 1_048_576,
                               4_194_304, 2 ** 31 - 2 ** 20])
def test_k11_ranges_cover_the_rows(R, monkeypatch):
    """K11's split of the sorted rows over the warps of a 132-SM card
    (enum_ranges, which the C entry checks): spans of a multiple of 4
    rows and below 2^21 (the count fields), every row in exactly one
    range, a range a warp and one CTA a SM."""
    dev = torch.device("cpu")
    monkeypatch.setitem(port._SM_COUNTS, dev.index, 132)
    span, nranges, grid = port.enum_ranges(dev, R)
    assert 4 <= span < 2 ** 21 and span % 4 == 0
    assert (nranges - 1) * span < R <= nranges * span
    assert grid == -(-nranges // port._K11_WARPS) <= 132
    if R == 4_194_304:
        # config 5's partition: 1,988 rows a warp, every SM
        assert (span, nranges, grid) == (1988, 2110, 132)


@pytest.mark.parametrize("name", SORTED_CASES)
def test_sorted_device_prune_matches_reference(name):
    cfg, pcfg, packed, ppacked = _run_both(name, "gather")
    assert port.enum_radix(pcfg) == 0 and pcfg.strategy == "sorted"
    want = np.asarray(packed["main"])
    np.testing.assert_array_equal(ppacked["main"].numpy(), want)
    np.testing.assert_array_equal(ppacked["table"].numpy(),
                                  np.asarray(packed["table"]))
    H = len(port.hist_aggs(pcfg))
    meta = want[0]
    P = port.table_prefix(pcfg)
    assert meta[4 + H] == P
    if name == "sorted-group-cap":
        # the totals are the table's: groups past the cap are not in them
        assert meta[0] > pcfg.max_groups
        assert meta[6 + H] < _make(name)[2].sum()


@pytest.mark.parametrize("name", SORTED_CASES)
def test_prune_topk_gather_matches_reference(name):
    """The device prune's wrapper (K12's select and K10's gather in one
    call) on the port's K10 table and scores, against pack_outputs'
    device prune (1874-1900) on the reference's scan of the same batch:
    the winners' indices (lax.top_k of the same scores), the pruned table
    and main's prefix rows, word for word."""
    cfg, cols, nrec, fvals, bits, tb = _make(name, "gather")
    jcols = {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
             cols.items()}
    packed, out = ref.scan_packed_jit(
        cfg, jcols, jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(tb, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    P = port.table_prefix(pcfg)
    live = (out["count"] > 0) | (out["samples"] > 0)
    if cfg.prune_agg >= 0:
        acnt = out[f"agg{cfg.prune_agg}_count"]
        score = jnp.where(live & (acnt > 0),
                          out[f"agg{cfg.prune_agg}_wv"].astype(jnp.float32)
                          / jnp.maximum(acnt, 1).astype(jnp.float32),
                          -jnp.inf)
    else:
        score = jnp.where(live, out["count"], -1)
    want_pidx = np.asarray(jax.lax.top_k(score, P)[1])
    parts = port.scan_core(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), tuple(torch.from_numpy(b) for b in bits),
        tb)
    R = nrec.size * cols["k0"][0].shape[1]
    lay = port.packed_layout(pcfg, R)
    main = torch.zeros((lay["rows"], lay["W"]), dtype=torch.int64)
    k10 = port.sorted_pack(pcfg, parts["k8"], parts["spill"],
                           parts["pairs"], parts["nouts"], main, R)
    pidx, ptable = port.prune_topk_gather(pcfg, k10["score"], k10["table"],
                                          main)
    np.testing.assert_array_equal(pidx.numpy(), want_pidx)
    np.testing.assert_array_equal(ptable.numpy(), np.asarray(packed["table"]))
    want_main = np.asarray(packed["main"])
    np.testing.assert_array_equal(main.numpy()[1:1 + P], want_main[1:1 + P])
    assert len(want_pidx) == P and (want_main[1:1 + P] != 0).any()


# ---------------------------------------------------------------------------
# K12's plain version against _topk_rows and lax.top_k
# ---------------------------------------------------------------------------

def _topk_cases():
    """(name, score, k): the cases of tests/test_scan_units.py:20-54 and
    f32 -inf ties, int64 scores and k = R."""
    out = []
    for seed, k in ((0, 100), (1, 1000), (2, 17)):
        rng = np.random.default_rng(seed)
        s = rng.integers(0, 50, 64 * 1024).astype(np.int32)
        out.append((f"ties-seed{seed}-k{k}", np.where(s > 0, s, -1)
                    .astype(np.int32), k))
    s = np.zeros(16 * 1024, np.int32)
    s[:200] = 7
    out.append(("200-maxima-in-one-tile", s, 150))
    s = np.full(8 * 1024, -1, np.int32)
    s[[5, 999, 7000]] = [3, 9, 1]
    out.append(("fewer-live-than-k", s, 64))
    rng = np.random.default_rng(9)
    f = np.where(rng.random(32 * 1024) < 0.3,
                 rng.integers(-5, 5, 32 * 1024) / 4.0, -np.inf)
    out.append(("f32-inf-ties", f.astype(np.float32), 1000))
    out.append(("int64", (rng.integers(-3, 3, 20_000)
                          * (1 << 40)).astype(np.int64), 300))
    out.append(("k-equals-r", rng.integers(0, 4, 500).astype(np.int64), 500))
    # the general form's corner cases, as chip_smoke.py runs them through
    # the kernel: all-equal keys, the types' extremes, 56 shared top bits,
    # config 5's ties straddling k, k = 4,096
    out += [(f"card-{name}", *chip_smoke.k12g_case(name))
            for name in chip_smoke.K12G_CASES]
    return out


@pytest.mark.parametrize("case", _topk_cases(), ids=lambda c: c[0])
def test_topk_rows_plain_matches_lax_top_k(case):
    _, score, k = case
    want = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
    got = port.topk_rows_plain(torch.from_numpy(score), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if score.dtype == np.int32:
        tiled = ref._topk_rows(jnp.asarray(score), jnp.asarray(score > 0), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(tiled))


# ---------------------------------------------------------------------------
# query level
# ---------------------------------------------------------------------------

def _ingest(table, chunk, steps):
    """Ingest (ints, strs, valid) steps with `chunk` rows a block."""
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = chunk
    try:
        for ints, strs, valid in steps:
            table.ingest_columns(ints=ints, strs=strs, valid=valid)
    finally:
        ref_digest.CHUNK_SIZE = old


def _zipf_users(d: str, part: int):
    """A config-5 partition cut down (scripts/bench_configs.py:64-98):
    userid ~ Zipf(1.2) folded over 200,000 users as `person{u}`, plus a
    tail of users seen once, so the dictionary passes the dense slot cap;
    weight in {1, 10, 100} with missing rows; 28 blocks of 512 rows."""
    rng = np.random.default_rng(900 + part * 1000)
    uid = np.concatenate([rng.zipf(1.2, 7000) % 200_000,
                          300_000 + part * 10_000 + np.arange(7000)])
    rng.shuffle(uid)
    n = len(uid)
    steps = [({"weight": rng.choice([1, 10, 100], n).astype(np.int64),
               "time": 1_755_000_000 - rng.integers(0, 2419200, n)},
              {"userid": [f"person{u}" for u in uid]},
              {"weight": rng.random(n) > 0.1})]
    _ingest(RefTable("sessions_zipf", RefFlags(
        dir=d, table="sessions_zipf", skip_compact=True)), 512, steps)
    return d


@pytest.fixture(scope="module")
def zipf_parts(tmp_path_factory):
    return [_zipf_users(str(tmp_path_factory.mktemp(f"zipf_p{p}")), p)
            for p in (1, 2)]


@pytest.fixture(scope="module")
def wide_ints(tmp_path_factory):
    """An int key spanning more than ENUM_RADIX_CAP values (packed, not
    enumerable), and a legacy copy whose first block has no exact bounds
    (unpacked keys): both take the sorted strategy's device prune; 18
    blocks of 64 rows."""
    import shutil

    from sybil_tpu import codec
    d = str(tmp_path_factory.mktemp("wide_ints"))
    rng = np.random.default_rng(31)
    n = 1100
    g = (rng.zipf(1.3, n) % 400) * 7000
    _ingest(RefTable("wide", RefFlags(dir=d, table="wide",
                                      skip_compact=True)), 64,
            [({"g": g.astype(np.int64), "h": np.arange(n) % 3,
               "v": rng.integers(-50, 400, n)}, {}, {})])
    shutil.copytree(os.path.join(d, "wide"), os.path.join(d, "legacy"))
    first = sorted(b for b in os.listdir(os.path.join(d, "legacy"))
                   if b.startswith("block"))[0]
    info = os.path.join(d, "legacy", first, "info.json")
    meta = codec.read_json(info)
    meta["int_exact"] = {}
    codec.write_json_atomic(info, meta)
    return d


# name -> (fixture, table, CLI arguments past -dir/-table, strategy the
# port scans with, whether K12 runs)
QUERIES = {
    # config 5 on one partition: the default -limit 100 and -prune-sort
    # $COUNT ask for the device prune; the userid dictionary passes the
    # dense cap, so the enumerated strategy runs
    "config-5-count": ("zipf", "sessions_zipf",
                       ["-group", "userid", "-int", "weight", "-op", "avg"],
                       "enum"),
    # the f32 score: prune by the weight's mean
    "config-5-prune-weight": ("zipf", "sessions_zipf",
                              ["-group", "userid", "-int", "weight", "-op",
                               "avg", "-prune-sort", "weight", "-limit",
                               "7"], "enum"),
    # two keys, weighted
    "config-5-two-keys-weighted": ("zipf", "sessions_zipf",
                                   ["-group", "userid,weight", "-int",
                                    "weight", "-weight-col", "weight",
                                    "-limit", "20"], "enum"),
    # a packed int key past ENUM_RADIX_CAP: the sorted device prune
    "sorted-prune-packed": ("wide", "wide",
                            ["-group", "g", "-int", "v", "-limit", "5"],
                            "sorted"),
    # unpacked keys (a legacy block without exact bounds), mean prune
    "sorted-prune-unpacked-mean": ("wide", "legacy",
                                   ["-group", "g,h", "-int", "v",
                                    "-prune-sort", "v", "-limit", "4"],
                                   "sorted"),
}


def _query_dir(name, request):
    fixture, table = QUERIES[name][:2]
    if fixture == "zipf":
        return request.getfixturevalue("zipf_parts")[0], table
    return request.getfixturevalue("wide_ints"), table


def _cli_out(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _configs_seen(monkeypatch):
    """Record every ScanConfig the port's engine scans."""
    seen = []
    real = port.scan_packed

    def spy(cfg, *args, **kw):
        seen.append(cfg)
        return real(cfg, *args, **kw)

    monkeypatch.setattr(port, "scan_packed", spy)
    return seen


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pruned_query_output_matches_reference(request, name, capsys,
                                               monkeypatch):
    d, table = _query_dir(name, request)
    seen = _configs_seen(monkeypatch)
    for fmt in (["-json"], []):
        argv = ["query", "-dir", d, "-table", table, "-device-batch", "8",
                *QUERIES[name][2], *fmt]
        want = _cli_out(ref_cli.main, argv, capsys)
        got = _cli_out(port_cli.main, argv + ["-device", "cpu"], capsys)
        assert got == want
        if fmt:
            assert len(json.loads(got)) >= 3
    assert {cfg.prune_topk > 0 for cfg in seen} == {True}
    enum = {port.enum_radix(cfg) > 0 for cfg in seen}
    assert enum == {QUERIES[name][3] == "enum"}
    if name == "sorted-prune-unpacked-mean":
        assert {bool(cfg.sort_pack) for cfg in seen} == {False}


def _result_state(qr):
    """Every row of a result: keys, counts, hist count/avg/min/max; the
    Cumulative row, the matched count and the sorted order."""
    def hist(h):
        return (h.count, h.avg, getattr(h, "min", None),
                getattr(h, "max", None))
    return ({k: (tuple(r.key_tuple), r.count, r.samples,
                 {c: hist(h) for c, h in r.hists.items()})
             for k, r in qr.results.items()},
            (qr.cumulative.count, qr.cumulative.samples), qr.matched_count,
            [r.group_key for r in qr.sorted])


def _skewed(d: str):
    """tests/test_query_features.py:29-51's skewed uid table: three heavy
    uids with unambiguous margins over a tail, 512-row blocks."""
    import random
    rng = random.Random(3)
    rows = []
    for uid, cnt in ((0, 1200), (1, 800), (2, 500)):
        rows += [uid] * cnt
    for uid in range(3, 400):
        rows += [uid] * rng.randint(3, 8)
    rng.shuffle(rows)
    uid = np.asarray(rows, np.int64)
    _ingest(RefTable("t", RefFlags(dir=d, table="t", skip_compact=True)),
            512, [({"uid": uid, "v": np.arange(len(uid)) % 97}, {}, {})])
    return d


def _means(d: str):
    """tests/test_query_features.py:89-116: uid k has v ~ 10 k."""
    import random
    rng = random.Random(7)
    rows = [(u, u * 10 + rng.randint(0, 3)) for u in range(60)
            for _ in range(40)]
    rng.shuffle(rows)
    _ingest(RefTable("t", RefFlags(dir=d, table="t", skip_compact=True)),
            128, [({"uid": np.asarray([u for u, _ in rows], np.int64),
                    "v": np.asarray([v for _, v in rows], np.int64)},
                   {}, {})])
    return d


def _gate(d: str, nblocks: int):
    """tests/test_query_features.py:429-444: n/2 int uids over nblocks
    blocks of 256 rows."""
    n = nblocks * 256
    _ingest(RefTable("t", RefFlags(dir=d, table="t", skip_compact=True)),
            256, [({"uid": (np.arange(n) % (n // 2)).astype(np.int64),
                    "v": np.ones(n, np.int64)}, {}, {})])
    return d


# name -> (table, (groups, aggs, limit, prune_by), device_batch,
# strip lane_row_bounds)
RUNS = {
    "prune-intermediate-topk": ("skewed", (("uid",), (), 3, "$COUNT"), 2,
                                False),
    "prune-disabled-exact": ("skewed", (("uid",), (), 100, ""), 2, False),
    "prune-by-agg-mean": ("means", (("uid",), ("v",), 2, "v"), 2, False),
    "gate-8-blocks": ("gate8", (("uid",), ("v",), 5, "$COUNT"), 64, False),
    "gate-20-blocks": ("gate20", (("uid",), ("v",), 5, "$COUNT"), 64, False),
    # tests/test_query_features.py:492-550, 606-620 on config 5's table
    "enum-high-card-prune": ("zipf", (("userid",), ("weight",), 5,
                                      "$COUNT"), 4, False),
    "enum-fallback-no-bounds": ("zipf", (("userid",), ("weight",), 5,
                                         "$COUNT"), 4, True),
    "enum-mean-cumulative": ("zipf", (("userid",), ("weight",), 10,
                                      "weight"), 8, False),
}


@pytest.fixture(scope="module")
def run_tables(tmp_path_factory, zipf_parts):
    mk = lambda tag: str(tmp_path_factory.mktemp(tag))  # noqa: E731
    return {"skewed": (_skewed(mk("skewed")), "t"),
            "means": (_means(mk("means")), "t"),
            "gate8": (_gate(mk("gate8"), 8), "t"),
            "gate20": (_gate(mk("gate20"), 20), "t"),
            "zipf": (zipf_parts[0], "sessions_zipf")}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_query_prune_matches_reference(run_tables, name, monkeypatch):
    key, (groups, aggs, limit, prune_by), batch, strip = RUNS[name]
    d, table = run_tables[key]
    if strip:
        for eng in (ref_engine, port_engine):
            real = eng.BoundQuery.apply_exact_bounds

            def stripped(self, infos, dirs, real=real):
                real(self, infos, dirs)
                self.config = dataclasses.replace(self.config,
                                                  lane_row_bounds=())
            monkeypatch.setattr(eng.BoundQuery, "apply_exact_bounds",
                                stripped)
    seen = _configs_seen(monkeypatch)
    want = ref_engine.run_query(
        RefTable(table, RefFlags(dir=d, table=table)),
        RefParams(groups=groups, aggs=tuple(RefAgg(a, "avg") for a in aggs),
                  limit=limit, prune_by=prune_by),
        RefFlags(dir=d, table=table, device_batch=batch))
    flags = Flags(dir=d, table=table, device="cpu", device_batch=batch)
    got = port_engine.run_query(
        Table(table, flags),
        QueryParams(groups=groups, aggs=tuple(AggDef(a, "avg") for a in aggs),
                    limit=limit, prune_by=prune_by), flags)
    assert _result_state(got) == _result_state(want)
    assert got.cumulative.count == sum(
        b.num_records for b in Table(table, flags).block_infos().values()
    ) or key == "zipf"
    if key == "zipf":
        cfg = seen[0]
        assert port.enum_radix(cfg) > 0
        assert bool(cfg.lane_row_bounds) != strip
        assert len(got.results) <= min(limit * 10, 1000)
        assert got.matched_count == 14_000 == got.cumulative.samples


# ---------------------------------------------------------------------------
# the node protocol
# ---------------------------------------------------------------------------

C5_ARGV = ["-table", "sessions_zipf", "-group", "userid", "-int", "weight",
           "-op", "avg", "-limit", "100", "-device-batch", "8"]


@pytest.mark.parametrize("fmt", ["-json", "text"])
def test_encode_results_and_aggregate_match_reference(zipf_parts, tmp_path,
                                                      capsys, monkeypatch,
                                                      fmt):
    """Config 5's protocol: each node answers -encode-results through both
    CLIs with equal bytes; `aggregate` over the two result directories
    prints equal bytes, its counts summing to both tables' rows."""
    dirs = {}
    for pkg, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        res = tmp_path / pkg
        res.mkdir()
        for i, d in enumerate(zipf_parts):
            argv = ["query", "-dir", d, *C5_ARGV, "-encode-results"]
            out = _cli_out(main, argv + (["-device", "cpu"]
                                         if pkg == "port" else []), capsys)
            (res / f"node{i}.json").write_text(out)
        dirs[pkg] = str(res)
    for i in range(2):
        assert (tmp_path / "port" / f"node{i}.json").read_bytes() == \
            (tmp_path / "ref" / f"node{i}.json").read_bytes()
    outs = {}
    agg_argv = C5_ARGV[2:] + ([fmt] if fmt == "-json" else [])
    for pkg, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        outs[pkg] = _cli_out(main, ["aggregate", *agg_argv, dirs[pkg]],
                             capsys)
    assert outs["port"] == outs["ref"]
    if fmt == "-json":
        rows = json.loads(outs["port"])
        assert len(rows) >= 100


def test_wire_round_trip_matches_reference():
    """Basic, multi and t-digest hists, a distinct HLL and time rows
    survive the port's wire format, and encode to the reference's
    bytes."""
    from sybil_tpu.parallel import wire as ref_wire
    from sybil_tpu.query import engine as ref_eng
    from sybil_tpu.query import hist as ref_hist
    from sybil_tpu.query import hll as ref_hll
    from sybil_tpu.query import spec as ref_spec
    from sybil_tpu_torch.parallel import wire
    from sybil_tpu_torch.query import engine as eng
    from sybil_tpu_torch.query import hist, hll, spec

    def build(H, HL, S, E):
        rng = np.random.default_rng(3)
        qr = E.QueryResults()
        rows = {}
        for gk in ("a\t", "b\t"):
            r = S.Result()
            r.group_key, r.count, r.samples = gk, 40, 40
            b = H.BasicHist(0, 1000, 0, percentile_mode=True)
            m = H.MultiHist(0, 5000, 0, percentile_mode=True)
            t = H.TDigestHist(0, 1000)
            for v in rng.integers(0, 6000, 40).tolist():
                b.add_weighted_value(v, 2, True)
                m.add_weighted_value(v, 1, False)
                t.add_weighted_value(v, 3, True)
            r.hists = {"b": b, "m": m, "t": t}
            r.distinct = HL.HLL()
            r.distinct.registers[rng.integers(0, len(r.distinct.registers),
                                              50)] = 5
            rows[gk] = r
        qr.results = rows
        qr.time_results = {1000: dict(rows)}
        qr.cumulative = rows["a\t"]
        qr.matched_count = 80
        return qr

    params = spec.QueryParams(groups=("g",))
    got = wire.results_to_wire(build(hist, hll, spec, eng), params)
    want = ref_wire.results_to_wire(
        build(ref_hist, ref_hll, ref_spec, ref_eng),
        ref_spec.QueryParams(groups=("g",)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    back = wire.results_from_wire(json.loads(json.dumps(got)))
    again = wire.results_to_wire(back, params)
    assert json.dumps(again, sort_keys=True) == json.dumps(got,
                                                           sort_keys=True)
    assert back.matched_count == 80 and set(back.time_results) == {1000}
