"""Port filters, histograms and outliers (K2-K5 plain versions) against
the JAX reference.

The same numpy batch goes through sybil_tpu.ops.scan.scan_packed_jit and
sybil_tpu_torch.ops.scan.scan_packed (CPU tensors) with the same filter
constants and regex bitsets; the packed download buffer `main` must agree
word for word.  Where a packed section overflows (more outliers than
kmax, more live groups than hist_prefix), the raw outputs the engine then
fetches must agree too."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sybil_tpu.ops import scan as ref
from sybil_tpu_torch.ops import scan as port

B, C = 3, 1024
R = B * C
DICT = 10                      # ids of the str filter column
BITS = np.array([i % 3 == 0 for i in range(DICT)])   # a regex's matches


def _limbs(x: int) -> int:
    return 1 if x < 1 << 8 else 2 if x < 1 << 16 else 4 if x < 1 << 32 else 8


# name -> options.  keys: group key bounds; hist: per agg (hist_min,
# bucket_size, nv, discard_min, discard_max) or "multi" or None (avg);
# filters: (col, op, kind, constant)
BASIC = (0, 10, 20, 0, 400)
CASES = {
    "int-gt": dict(filters=[("fi", "gt", "int", 40)]),
    "int-lt": dict(filters=[("fi", "lt", "int", 40)]),
    "int-eq": dict(filters=[("fi", "eq", "int", 7)]),
    "int-neq": dict(filters=[("fi", "neq", "int", 7)]),
    "str-eq": dict(filters=[("fs", "eq", "str", 4)]),
    "str-neq": dict(filters=[("fs", "neq", "str", 4)]),
    "str-eq-never-ingested": dict(filters=[("fs", "eq", "str", -1)]),
    "str-neq-never-ingested": dict(filters=[("fs", "neq", "str", -1)]),
    "re": dict(filters=[("fs", "re", "str", 0)]),
    "nre-and-int": dict(filters=[("fs", "nre", "str", 0),
                                 ("fi", "gt", "int", 10)]),
    "unknown-op": dict(filters=[("fi", "in", "int", 3)]),
    "weighted-matmul-form": dict(weight=True, limbs=True),
    "weighted-scatter-form": dict(weight=True),
    "multihist-sub-outliers": dict(hist=["multi"], weight=True, limbs=True),
    "outliers-below-kmax": dict(max_out=1024),
    "outliers-above-kmax": dict(max_out=16,
                                filters=[("fs", "neq", "str", 2)]),
    "hist-prefix-below-live": dict(keys=[(0, 5), (0, 6)], hist_prefix=4),
    "no-groups": dict(keys=[], weight=True),
    "not-compact": dict(keys=[(0, 126)]),
    "global-table": dict(keys=[(0, 90), (0, 89)], hist=[(0, 40, 12, 0, 400)],
                         hist_prefix=8),
    "negative-trunc-div": dict(hist=[(0, 7, 30, -150, 400)]),
    "two-hists-and-avg": dict(hist=[BASIC, None, "multi"], weight=True,
                              partial=True),
}


def _multi_edges(lo: int, hi: int):
    """A multihist layout over [lo, hi]: top range first, as
    query/hist.py:multi_hist_layout builds it (sizes small enough that
    values overflow each sub's bucket array)."""
    subs, off = [], 0
    for smin, smax, bs, nv in ((200, hi, 8, 20), (100, 199, 4, 20),
                               (lo, 99, 3, 30)):
        subs.append((smin, smax, bs, nv, off))
        off += nv
    return tuple(subs), off


def _make(name):
    """-> (reference ScanConfig, {col: (values, valid)}, nrec,
    filter_vals, bitsets)."""
    o = CASES[name]
    rng = np.random.default_rng(1000 + sorted(CASES).index(name))
    cols = {}

    def put(col, v, m):
        cols[col] = (v.astype(np.int64).reshape(B, C), m.reshape(B, C))

    bounds = o.get("keys", [(0, 5)])
    for i, (mn, card) in enumerate(bounds):
        put(f"k{i}", rng.integers(mn, mn + card, R), rng.random(R) < 0.9)
    put("fi", rng.integers(0, 80, R), rng.random(R) < 0.9)
    put("fs", rng.integers(0, DICT, R), rng.random(R) < 0.9)
    weight = o.get("weight", False)
    wmax = 1
    if weight:
        put("w", rng.integers(0, 101, R), rng.random(R) < 0.8)
        wmax = 100
    aggs = []
    for a, h in enumerate(o.get("hist", [BASIC])):
        v = rng.integers(-200, 700, R)
        put(f"v{a}", v, rng.random(R) < 0.85)
        if h is None:
            aggs.append(ref.AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                    num_values=0, discard_min=-50,
                                    discard_max=600))
        elif h == "multi":
            subs, nv = _multi_edges(0, 300)
            aggs.append(ref.AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                    num_values=nv, discard_min=0,
                                    discard_max=650, sub_edges=subs))
        else:
            hmin, bs, nv, dmin, dmax = h
            aggs.append(ref.AggSpec(f"v{a}", hist_min=hmin, bucket_size=bs,
                                    num_values=nv, discard_min=dmin,
                                    discard_max=dmax))
    filters, fvals = [], []
    for col, op, kind, val in o.get("filters", []):
        filters.append(ref.FilterSpec(col, op, kind,
                                      0 if op in ("re", "nre") else -1))
        fvals.append(val)
    limbs, vbias = (), ()
    if o.get("limbs"):
        # byte-limb counts from the data's true bounds, as the engine's
        # apply_exact_bounds derives them (the reference's hist forms are
        # exact only under true bounds)
        wl = _limbs(wmax)
        limbs = [wl, 1]
        for agg in aggs:
            limbs += [1, wl, _limbs(wmax * (agg.discard_max
                                            - agg.discard_min))]
        limbs, vbias = tuple(limbs), tuple(a.discard_min for a in aggs)
    cfg = ref.ScanConfig(
        group_cols=tuple(f"k{i}" for i in range(len(bounds))),
        aggs=tuple(aggs), filters=tuple(filters),
        weight_col="w" if weight else "", key_bounds=tuple(bounds),
        track_outliers=True, lane_limbs8=limbs, agg_vbias=vbias,
        max_out=o.get("max_out", 1024),
        hist_prefix=o.get("hist_prefix", 128))
    nrec = np.full(B, C, dtype=np.int32)
    if o.get("partial"):
        nrec[:] = [0, 700, 1]
    return cfg, cols, nrec, np.asarray(fvals, dtype=np.int64), (BITS,)


def _run_both(name):
    cfg, cols, nrec, fvals, bits = _make(name)
    assert cfg.strategy == "dense"
    packed, out = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
              cols.items()},
        jnp.asarray(nrec), jnp.asarray(fvals),
        tuple(jnp.asarray(b) for b in bits), jnp.asarray(1, jnp.int64), {})
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), tuple(torch.from_numpy(b) for b in bits))
    return cfg, pcfg, np.asarray(packed["main"]), out, \
        ppacked["main"].numpy(), raw


@pytest.mark.parametrize("name", sorted(CASES))
def test_hist_scan_main_matches_reference(name):
    cfg, pcfg, want, out, got, raw = _run_both(name)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    hist = port.hist_aggs(pcfg)
    assert hist and int(want[0, 1]) == 0          # no spill
    layout = port.packed_layout(pcfg, R)
    nouts = [int(want[0, 2 + i]) for i in range(len(hist))]
    live = int(want[0, 0])
    o = CASES[name]
    if "max_out" in o:
        assert 0 < nouts[0] <= layout["kmax_out"] if o["max_out"] > 16 \
            else nouts[0] > layout["kmax_out"]
    if "hist_prefix" in o:
        assert live > layout["Ph"]
    if name == "multihist-sub-outliers":
        assert nouts[0] > 0
    if name.startswith("str-eq-never") or name == "unknown-op":
        assert live == 0
    # the raw outputs escalation fetches
    for ai in hist:
        np.testing.assert_array_equal(raw[f"agg{ai}_out_mask"].numpy(),
                                      np.asarray(out[f"agg{ai}_out_mask"]))
        np.testing.assert_array_equal(raw[f"agg{ai}_out_val"].numpy(),
                                      np.asarray(out[f"agg{ai}_out_val"]))
        full = np.asarray(out[f"agg{ai}_hist"])           # [slots, nv]
        active = np.nonzero(np.asarray(out["count"]) > 0)[0]
        np.testing.assert_array_equal(
            port.fetch_hist_rows(raw, ai, active), full[active])
        keys, vals = port.fetch_outliers(pcfg, raw, ai)
        mask = np.asarray(out[f"agg{ai}_out_mask"])
        np.testing.assert_array_equal(
            keys, np.asarray(out["sorted_gkeys"])[mask])
        np.testing.assert_array_equal(
            vals, np.asarray(out[f"agg{ai}_out_val"])[mask])


@pytest.mark.parametrize("name", ["global-table", "int-gt"])
def test_hist_table_paths(name):
    cfg, _, _, _, _ = _make(name)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    want = "global" if name == "global-table" else "shared"
    assert port.dense_hist_path(pcfg, 0) == want
    for R_ in (R, 128 * 65536):
        assert port.packed_layout(pcfg, R_) == ref.packed_layout(cfg, R_)
        assert port.dense_table_plan(pcfg, R_) == \
            ref.dense_table_plan(cfg, R_)
