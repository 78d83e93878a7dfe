"""Port of the two pack kernels' plain versions (K3 dense_pack with its
dense_keyed form, K10 sorted_pack with its enum_pack entry) and their
launch plans, against the JAX reference.

Scan level: the same seeded numpy batch goes through sybil_tpu.ops.scan.
scan_packed_jit (pack_outputs, _mask_positions) and the port's
scan_packed (CPU tensors: pack_parts, then dense_pack_plain,
sorted_pack_plain or enum_pack_plain); the packed `main` buffer and the
keyed table must agree word for word.  The cases sit on the packs' edges:
no hist pairs, exactly and more than Hcap pairs, distinct pairs past
max_pairs, Ph and Phll above the live slots, int32 wire columns of an
odd count, the device prune by $COUNT with tied counts and by a mean
with count-0 and dead slots, dense_keyed with a time key, enum_pack with
fewer winners than the prefix.  A mesh scan's merged tables (K3's keyed
and K10's merged form) go through the reference's pack_outputs and the
port's pack_parts directly.

Plans: for every case the cached launch plan of each pack kernel equals
a fresh computation, its layout equals packed_layout's and is read-only,
and two configs that differ in one field never share a plan."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sybil_tpu.ops import scan as ref
from sybil_tpu_torch.ops import scan as port

B, C = 2, 1024
R = B * C

# name -> options.  keys: [(lo, hi) of the values, (min, card) bound or
# None]; dense: keys bounds go to key_bounds (else sort_pack, or nothing);
# hist: per aggregation "basic" | "tdigest" | None, with (dmin, dmax) of
# its discard range; distinct: [(lo, hi)] of the distinct columns; time:
# (lo, hi, bucket); live: the share of rows whose keys are valid;
# weight; track; extra: ScanConfig fields; ncount: run the reference
# first and set max_hist_pairs to its pair count
CASES = {
    "sorted, no hist pairs": dict(keys=[((0, 30), None)], hist=["basic"],
                                  discard=(10 ** 6, 10 ** 7)),
    "sorted, exactly Hcap pairs": dict(keys=[((0, 30), None)],
                                       hist=["basic"], ncount=True),
    "sorted, more than Hcap pairs": dict(
        keys=[((0, 30), None)], hist=["basic", "tdigest"], weight=True,
        extra=dict(max_hist_pairs=40)),
    "sorted, distinct pairs past max_pairs": dict(
        keys=[((0, 20), None)], hist=[], distinct=[(0, 9), (-50, 50)],
        extra=dict(max_pairs=100)),
    "dense, Ph above the live slots": dict(
        keys=[((0, 3), (0, 40))], dense=True, hist=["basic", None],
        track=True, extra=dict(hist_prefix=128)),
    "dense, Phll above the live slots": dict(
        keys=[((0, 3), (0, 30))], dense=True, hist=[],
        distinct=[(-1000, 1000)], extra=dict(hll=True, hll_ship=8)),
    "dense, i32 wire columns of an odd count": dict(
        keys=[((0, 6), (0, 6))], dense=True, hist=[None],
        extra=dict(lane_row_bounds=(1, 1, 1, 1, 100))),
    "sorted, prune by $COUNT with ties": dict(
        keys=[((0, 400), None)], hist=[None], live=0.9,
        extra=dict(prune_topk=40, prefix_rows=40)),
    "sorted, prune by a mean, count-0 and dead slots": dict(
        keys=[((0, 300), None)], hist=[None, None], agg_valid=0.02,
        extra=dict(prune_topk=64, prune_agg=1, max_groups=1000)),
    "dense_keyed with a time key": dict(
        keys=[((0, 5), (0, 5))], dense=True, hist=["basic"],
        time=(-7200, 90_000, 3600), track=True,
        extra=dict(no_compact_table=True)),
    "enum_pack with Pk < P": dict(
        keys=[((0, 30), (0, 30)), ((0, 4), (0, 4))], hist=[None],
        enum=True, extra=dict(prune_topk=5000, prefix_rows=5000)),
}


def _make(name, **over):
    """-> (reference ScanConfig, {col: (values, valid)}, nrec, time
    bucket), numpy, from the case's seed."""
    o = CASES[name]
    rng = np.random.default_rng(1800 + sorted(CASES).index(name))
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    groups, bounds = [], []
    for i, ((lo, hi), bound) in enumerate(o["keys"]):
        put(f"k{i}", rng.integers(lo, hi, R), o.get("live", 0.95))
        groups.append(f"k{i}")
        bounds.append(bound)
    kw, tb = {}, 1
    if "time" in o:
        lo, hi, tb = o["time"]
        put("t", rng.integers(lo, hi, R), 0.97)
        kw["time_col"] = "t"
        tq = (-(-lo // tb) - 1, hi // tb + 1)
        bounds = [(tq[0], tq[1] - tq[0] + 1)] + bounds
    if o.get("dense"):
        kw["key_bounds"] = tuple(bounds)
    elif o.get("enum"):
        kw["sort_pack"] = tuple(bounds)
    else:
        kw["force_sorted"] = True
    aggs = []
    dmin, dmax = o.get("discard", (0, 2500))
    for a, h in enumerate(o["hist"]):
        put(f"v{a}", rng.integers(0, 300, R), o.get("agg_valid", 0.85))
        if h is None:
            aggs.append(ref.AggSpec(f"v{a}", 0, 0, 0, -10, 2500))
        elif h == "tdigest":
            aggs.append(ref.AggSpec(f"v{a}", 0, 1, 302, dmin, dmax))
        else:
            aggs.append(ref.AggSpec(f"v{a}", 0, 10, 40, dmin, dmax))
    dcols = []
    for d, (lo, hi) in enumerate(o.get("distinct", [])):
        put(f"d{d}", rng.integers(lo, hi, R), 0.9)
        dcols.append(f"d{d}")
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    extra = dict(o.get("extra", {}), **over)
    cfg = ref.ScanConfig(
        group_cols=tuple(groups), aggs=tuple(aggs), filters=(),
        distinct_cols=tuple(dcols), weight_col="w" if o.get("weight") else "",
        track_outliers=bool(o.get("track")), **kw, **extra)
    nrec = np.array([C, C - 5], dtype=np.int32)
    return cfg, cols, nrec, tb


def _ref_pack(cfg, cols, nrec, tb):
    return ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
              cols.items()}, jnp.asarray(nrec), jnp.zeros((0,), jnp.int64),
        (), jnp.asarray(tb, jnp.int64), {})[0]


def _run_both(name):
    cfg, cols, nrec, tb = _make(name)
    if CASES[name].get("ncount"):
        H = len([a for a in cfg.aggs if a.num_values])
        n = int(np.asarray(_ref_pack(cfg, cols, nrec, tb)["main"])[0, 7 + H])
        cfg, cols, nrec, tb = _make(name, max_hist_pairs=n)
    packed = _ref_pack(cfg, cols, nrec, tb)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, _ = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.zeros(0, dtype=torch.int64), (), tb)
    return cfg, pcfg, packed, ppacked


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_reference(name):
    cfg, pcfg, packed, ppacked = _run_both(name)
    want = np.asarray(packed["main"])
    got = ppacked["main"].numpy()
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if "table" in ppacked:
        np.testing.assert_array_equal(ppacked["table"].numpy(),
                                      np.asarray(packed["table"]))
    # each case reaches the edge it is named for
    o = CASES[name]
    layout = port.packed_layout(pcfg, R)
    meta = want[0]
    H = len(port.hist_aggs(pcfg))
    if o.get("dense"):
        assert pcfg.strategy == "dense"
        assert (pcfg.no_compact_table
                == (port.dense_table_plan(pcfg, R) is None))
    if name == "sorted, no hist pairs":
        assert meta[7 + H] == 0
    if name == "sorted, exactly Hcap pairs":
        assert meta[7 + H] == layout["Hcap"]
    if name == "sorted, more than Hcap pairs":
        assert min(meta[7 + H:7 + 2 * H]) > layout["Hcap"]
    if name == "sorted, distinct pairs past max_pairs":
        assert meta[2] > layout["kmax_pairs"]
    if name == "dense, Ph above the live slots":
        assert 0 < meta[0] < layout["Ph"]
    if name == "dense, Phll above the live slots":
        assert 0 < meta[0] < layout["Phll"]
    if name == "dense, i32 wire columns of an odd count":
        plan = port.dense_table_plan(pcfg, R)
        assert plan["i32"] and len(plan["cols"]) % 2 == 1
    if "prune" in name:
        assert pcfg.strategy == "sorted" and not port.enum_radix(pcfg)
        assert meta[4 + H] == port.table_prefix(pcfg) < meta[0]
    if name == "sorted, prune by $COUNT with ties":
        counts = ppacked["table"][:, pcfg.n_key_cols].numpy()
        assert len(np.unique(counts)) < len(counts)
    if name == "sorted, prune by a mean, count-0 and dead slots":
        acnt = ppacked["table"][:, pcfg.n_key_cols + 2 + 5 + 1].numpy()
        assert (acnt == 0).any()
    if name == "enum_pack with Pk < P":
        assert port.enum_radix(pcfg) > 0 and R < port.table_prefix(pcfg)


def _merged_inputs(dense: bool):
    """A mesh scan's merged table as the reference's pack_outputs and the
    port's pack_parts take it: group by k0 (and a time key on the sorted
    strategy), hist v0 with its outlier rows, avg v1."""
    rng = np.random.default_rng(1899 + dense)
    aggs = (ref.AggSpec("v0", 0, 10, 40, 0, 2500),
            ref.AggSpec("v1", 0, 0, 0, -10, 2500))
    cfg = ref.ScanConfig(
        group_cols=("k0",), aggs=aggs, filters=(), no_compact_table=True,
        track_outliers=True, max_hist_pairs=50, max_groups=300,
        prefix_rows=200,
        **(dict(key_bounds=((0, 40),)) if dense else
           dict(force_sorted=True, time_col="t")))
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    S = pcfg.dense_slots if dense else pcfg.max_groups
    K, A = pcfg.n_key_cols, 2
    sums = rng.integers(0, 10 ** 6, (S + 1, 2 + 3 * A))
    sums[rng.random(S + 1) < 0.4, :2] = 0
    sums[:, 2::3] = rng.integers(-2, 3, (S + 1, A))
    keys = rng.integers(-1, 10 ** 6, (S, K))
    mins = rng.integers(-9, 9, (S, A))
    maxs = rng.integers(-9, 9, (S, A))
    meta = np.array([rng.integers(0, S), 2, 7, 5, 61], np.int64)
    hist = rng.integers(0, 10 ** 6, (S, 40))
    out_mask = rng.random(R) < 0.3
    out_val = rng.integers(2500, 9000, R)
    kmat = rng.integers(-5, 10 ** 9, (R, K))
    out = {"keys": keys, "count": sums[:S, 0], "samples": sums[:S, 1],
           "num_groups": meta[0], "spill": meta[1],
           "shuffle_overflow": meta[2], "agg0_nout": meta[3],
           "agg0_out_mask": out_mask, "agg0_out_val": out_val,
           "sorted_gkeys": kmat}
    for ai in range(A):
        out[f"agg{ai}_exists"] = sums[:S, 2 + 3 * ai] > 0
        out[f"agg{ai}_count"] = sums[:S, 3 + 3 * ai]
        out[f"agg{ai}_wv"] = sums[:S, 4 + 3 * ai]
        out[f"agg{ai}_min"] = mins[:, ai]
        out[f"agg{ai}_max"] = maxs[:, ai]
    t = torch.from_numpy
    table = {"keys": t(keys), "sums": t(sums), "mins": t(mins),
             "maxs": t(maxs), "num_groups": t(meta[0:1])}
    raw = {"agg0_out_mask": t(out_mask), "agg0_out_val": t(out_val),
           "kmat": t(kmat), "cols": None, "time_bucket": 1}
    parts = {"R": R, "dev": torch.device("cpu"), "nouts": [t(meta[3:4])],
             "raw": raw}
    if dense:
        out["agg0_hist"] = hist
        parts.update(strategy="dense", hists=[t(hist)], hll=None,
                     k2=dict(table, spill=t(meta[1:2]),
                             overflow=t(meta[2:3])))
    else:
        bv = rng.integers(0, 40, R)
        w = rng.integers(0, 99, R)
        hp_mask = rng.random(R) < 0.05
        hp_keys = rng.integers(-5, 10 ** 9, (R, K))
        out.update(agg0_hp_mask=hp_mask, agg0_hp_keys=hp_keys,
                   agg0_hp_bv=bv, agg0_hp_w=w)
        parts.update(strategy="sorted", k8=table, spill=t(meta[1:2]),
                     overflow=t(meta[2:3]),
                     pairs=[{"hp_mask": t(hp_mask), "hp_keys": t(hp_keys),
                             "hp_bv": t(bv), "hp_w": t(w),
                             "npairs": t(np.array([hp_mask.sum()]))}])
    return cfg, pcfg, out, parts


@pytest.mark.parametrize("dense", [True, False], ids=["K3 keyed",
                                                      "K10 merged"])
def test_merged_pack_matches_reference(dense):
    """A mesh scan's merged table: K3's keyed form and K10's merged form
    (every aggregation's min and max, the overflow word) against
    pack_outputs, word for word."""
    cfg, pcfg, out, parts = _merged_inputs(dense)
    want = ref.pack_outputs(cfg, {k: jnp.asarray(v) for k, v in out.items()},
                            R)
    got = port.pack_parts(pcfg, parts)
    np.testing.assert_array_equal(got["main"].numpy(),
                                  np.asarray(want["main"]))
    if not dense:
        np.testing.assert_array_equal(got["table"].numpy(),
                                      np.asarray(want["table"]))


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

def _plans(pcfg):
    """-> [(kind, form, make)] of the pack kernels that run this config."""
    if pcfg.strategy == "dense":
        form = "keyed" if pcfg.no_compact_table else "compact"
        return [("dense_pack", form, port._dense_plan)]
    if port.enum_radix(pcfg):
        return [("enum_pack", "enum", port._enum_plan)]
    return [("sorted_pack", "table", port._sorted_plan),
            ("sorted_pack", "merged", port._sorted_plan)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_cached_plan_equals_fresh(name):
    """The cached plans of the case (the layout's, which the scan's
    pack_parts used, and each pack kernel's) equal a fresh computation;
    a plan's layout is packed_layout's and read-only, and a lookup by an
    equal config object finds the cached plan."""
    cfg, _, _, _ = _make(name)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    _run_both(name)
    for kind, form, make in _plans(pcfg) + [("layout", "",
                                             port._layout_plan)]:
        cached = port._plan(kind, pcfg, R, form, make)
        assert cached == make(pcfg, R, form)
        layout = cached if kind == "layout" else getattr(cached, "layout",
                                                         None)
        if layout is not None:
            assert dict(layout) == port.packed_layout(pcfg, R)
            with pytest.raises(TypeError):
                layout["rows"] = 0
        twin = port.config_from_fields(dataclasses.asdict(cfg))
        assert twin is not pcfg
        assert port._plan(kind, twin, R, form, make) is cached
        if kind != "layout":
            assert isinstance(cached.tmpl, bytes)


def _variants(base):
    """base with each field changed in turn -> [(field, config)]."""
    out = []
    for f in dataclasses.fields(base):
        v = getattr(base, f.name)
        if isinstance(v, bool):
            new = not v
        elif isinstance(v, int):
            new = v + 1
        elif isinstance(v, str):
            new = v + "x"
        elif f.name == "aggs":
            new = v + (port.AggSpec("v9", 0, 0, 0, 0, 1),)
        elif f.name == "filters":
            new = v + (port.FilterSpec("f", "eq", "int"),)
        elif f.name == "key_bounds":
            new = v + ((0, 3),)
        else:
            new = v + (1,) if not v or isinstance(v[0], int) else v + v[:1]
        out.append((f.name, dataclasses.replace(base, **{f.name: new})))
    return out


def test_configs_differing_in_one_field_never_share_a_plan():
    """A plan is keyed by the whole config: a config that differs from
    another in any one field (of every ScanConfig field) gets a plan of
    its own, whichever was looked up last, and so does another R or
    form."""
    cfg, _, _, _ = _make("sorted, more than Hcap pairs")
    base = port.config_from_fields(dataclasses.asdict(cfg))
    port._PLANS.clear()          # no cap reached while the test runs
    made = []

    def make(config, r, form):
        made.append((config, r, form))
        return object()

    first = port._plan("test", base, R, "f", make)
    seen = {id(first)}
    for field, var in _variants(base):
        assert var != base, field
        p = port._plan("test", var, R, "f", make)
        assert id(p) not in seen, field
        seen.add(id(p))
        assert port._plan("test", base, R, "f", make) is first, field
    assert port._plan("test", base, R + 1, "f", make) is not first
    assert port._plan("test", base, R, "g", make) is not first
    assert len(made) == len(dataclasses.fields(base)) + 3
    # the real plans too: a field the plan's values do not read (a hist
    # aggregation's bucket count) still keys a plan of its own; one they
    # do read (the pair section's cap) changes them
    a = port._plan("sorted_pack", base, R, "table", port._sorted_plan)
    var = dataclasses.replace(base, aggs=(dataclasses.replace(
        base.aggs[0], num_values=41),) + base.aggs[1:])
    assert port._plan("sorted_pack", var, R, "table",
                      port._sorted_plan) is not a
    var = dataclasses.replace(base, max_hist_pairs=41)
    b = port._plan("sorted_pack", var, R, "table", port._sorted_plan)
    assert b is not a and b != a
