"""K4 dense_hist and K13 hll_registers on chip_smoke.py's corner cases
(K4_CASES, K13_CASES; the card holds each kernel to its plain version on
the same cases at 4 x 65,536 rows): the port's plain versions against the
reference's functions on the same numpy batch, made smaller, tolerance 0.

K4: dense_hist_plain against sybil_tpu.ops.scan._hist_bucket,
_hist_scatter and _outlier_outputs (the counts, the outlier mask, values
and count).  K13: hll_registers_plain against _hll_registers, whose int
hash and rank are _hash_int_col and _hll_idx_rank.  Also the kernels'
route functions and launch plans, which the CPU reaches."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sybil_tpu.ops import scan as ref
from sybil_tpu_torch.ops import scan as port

B, C = 2, 4096


def _ref_config(fields):
    o = dict(fields)
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o["aggs"])
    o["filters"] = ()
    return ref.ScanConfig(**o)


def _torch_cols(cols):
    return {k: (torch.from_numpy(v), torch.from_numpy(m))
            for k, (v, m) in cols.items()}


@pytest.mark.parametrize("name", list(chip_smoke.K4_CASES))
def test_dense_hist_case_matches_reference(name):
    fields, gid, cols, Sc = chip_smoke.k4_case(name, B, C)
    pcfg = chip_smoke.k2w_config(port, fields)
    cfg = _ref_config(fields)
    assert port.config_from_fields(dataclasses.asdict(cfg)) == pcfg
    assert port.reduce_space(pcfg)[1] == Sc
    if name in chip_smoke.K4_ROUTES:
        assert port.dense_hist_path(pcfg, 0) == chip_smoke.K4_ROUTES[name]
    got = port.dense_hist_plain(pcfg, 0, _torch_cols(cols),
                                torch.from_numpy(gid))

    agg = cfg.aggs[0]
    v, m = (x.reshape(-1) for x in cols["v"])
    bv, inrange, is_out, nv = ref._hist_bucket(agg, jnp.asarray(v))
    keep = (gid != Sc - 1) & m & ~((v > agg.discard_max) |
                                   (v < agg.discard_min))
    hcontrib = jnp.asarray(keep) & inrange
    if cfg.weight_col:
        wv, wm = (x.reshape(-1) for x in cols["w"])
        weight = jnp.asarray(np.where(wm, wv, 1))
    else:
        weight = jnp.ones(B * C, jnp.int64)
    want = ref._hist_scatter(jnp.asarray(gid), hcontrib, weight, bv, nv, Sc,
                             weighted=bool(cfg.weight_col), wlimbs8=8)
    np.testing.assert_array_equal(got["hist"].numpy(), np.asarray(want))
    if pcfg.track_outliers:
        out = {}
        ref._outlier_outputs(out, cfg, 0, hcontrib, is_out,
                             jnp.asarray(v), None)
        np.testing.assert_array_equal(got["out_mask"].numpy(),
                                      np.asarray(out["agg0_out_mask"]))
        np.testing.assert_array_equal(got["out_val"].numpy(),
                                      np.asarray(out["agg0_out_val"]))
        assert int(got["nout"][0]) == int(out["agg0_nout"])
    else:
        assert got["out_mask"] is None and got["nout"] is None
    counts = got["hist"].numpy()
    if name == "every row in one bucket of one gid":
        assert np.count_nonzero(counts) == 1
    if name in ("a multihist value past its sub's array", "discard bounds",
                "a bucket size past 32 bits"):
        assert int(got["nout"][0]) > 0
    if name == "weights that wrap mod 2^64":
        # the exact sums, in Python integers: some leave int64, and each
        # count is its sum mod 2^64
        wv, wm = (x.reshape(-1) for x in cols["w"])
        exact = {}
        for x, ok, k, cell in zip(wv.tolist(), wm.tolist(),
                                  np.asarray(hcontrib).tolist(),
                                  (gid * agg.num_values
                                   + np.asarray(bv)).tolist()):
            if k:
                exact[cell] = exact.get(cell, 0) + (x if ok else 1)
        assert any(not -2 ** 63 <= x < 2 ** 63 for x in exact.values())
        for cell, x in exact.items():
            assert int(counts.reshape(-1)[cell]) == (
                (x + 2 ** 63) % 2 ** 64 - 2 ** 63)


@pytest.mark.parametrize("name", list(chip_smoke.K13_CASES))
def test_hll_registers_case_matches_reference(name):
    fields, gid, cols, hashes, Sc = chip_smoke.k13_case(name, B, C)
    pcfg = chip_smoke.k2w_config(port, fields)
    cfg = _ref_config(fields)
    assert port.config_from_fields(dataclasses.asdict(cfg)) == pcfg
    slots, pSc, _ = port.reduce_space(pcfg)
    assert pSc == Sc
    assert port.hll_route(pcfg) == chip_smoke.K13_ROUTES.get(name, "shared")
    bits = () if hashes is None else (torch.from_numpy(hashes.view(np.int64)),)
    got = port.hll_registers_plain(pcfg, _torch_cols(cols),
                                   torch.from_numpy(gid), bits).numpy()

    matched = gid != Sc - 1
    full = np.where(matched, gid, slots - 1).astype(np.int32)
    want = np.asarray(ref._hll_registers(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m))
              for k, (v, m) in cols.items()}, lambda x: x.reshape(-1),
        jnp.asarray(matched), jnp.asarray(full),
        () if hashes is None else (jnp.asarray(hashes),), slots))
    assert got.shape == (slots, port.HLL_M) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if name == "rank 51, a zero remainder":
        assert (got == 64 - port.HLL_P + 1).any()
    if name == "one register hit by every row":
        assert np.count_nonzero(got) == 1
    if name == "the dead slot":
        assert np.count_nonzero(got[slots - 1]) > np.count_nonzero(got[0])
    if name in ("MISSING values, int hash", "MISSING values, str hash"):
        # the missing rows' hash in every live plane
        v, m = (x.reshape(-1) for x in cols["d"])
        h = (ref._hash_int_col(jnp.asarray([-1])) if hashes is None
             else jnp.asarray(hashes[-1:]))
        idx, rank = (int(x[0]) for x in ref._hll_idx_rank(h))
        rows = ~m & matched
        assert rows.any()
        for g in np.unique(gid[rows]):
            assert got[g, idx] >= rank


def _hist_config(keys, nv, weight=False, bs=1):
    return port.ScanConfig(
        group_cols=tuple(f"k{i}" for i in range(len(keys))),
        aggs=(port.AggSpec("v", 0, bs, nv, 0, 10 ** 6),), filters=(),
        weight_col="w" if weight else "", key_bounds=tuple(keys))


@pytest.mark.parametrize("keys,nv,weight,route", [
    (((0, 5),), 166, False, "shared"),        # config 3: 6 x 166 words
    (((0, 8), (0, 9)), 101, False, "shared"),  # config 2: 90 x 101 words
    (((0, 7),), 3200, True, "shared"),         # 8 x 3,200 x 2 words: 200 KB
    (((0, 7),), 3201, True, "global"),
    (((0, 7),), 6400, False, "shared"),
    (((0, 7),), 6401, False, "global"),
    (((0, 90), (0, 89)), 12, True, "global"),
])
def test_dense_hist_path(keys, nv, weight, route):
    """K4's table by its narrow size: the CTA's shared table up to
    SHARED_TABLE_BYTES, else the global counts."""
    cfg = _hist_config(keys, nv, weight)
    assert port.dense_hist_path(cfg, 0) == route
    assert route in port.K4_PATHS


@pytest.mark.parametrize("card,route", [(1, "shared"), (5, "shared"),
                                        (10, "shared"), (11, "global"),
                                        (126, "global")])
def test_hll_route(card, route):
    """K13's form: shared while the Sc planes (16 KB each) fit
    SHARED_TABLE_BYTES (12 planes), else global."""
    cfg = port.ScanConfig(group_cols=("k0",), aggs=(), filters=(),
                          distinct_cols=("d",), key_bounds=((0, card),),
                          hll=True)
    _, Sc, _ = port.reduce_space(cfg)
    assert Sc == min(card + 2, 128)
    assert port.hll_route(cfg) == route


def test_tile_grid(monkeypatch):
    """One CTA a SM, no more than the 4,096-row tiles of the batch."""
    monkeypatch.setattr(port, "_sm_count", lambda dev: 132)
    dev = torch.device("cpu")
    assert port.tile_grid(dev, 8_388_608) == 132
    assert port.tile_grid(dev, 3 * 65536) == 48
    assert port.tile_grid(dev, 1) == 1


def test_launch_plans():
    """The launch plans hold what the config fixes: K4's bucket spans (nv
    x bucket size, at most 2^63; a multihist's per sub-range), its route
    and mode; K13's planes and form.  Cached per (config, R, form)."""
    cfg = _hist_config(((0, 5),), 20, bs=2 ** 62)
    p = port._hist_plan(cfg, 1024, "0")
    a = port.DenseHistArgs.from_buffer_copy(p.tmpl)
    assert a.span == 2 ** 63 and a.nsub == 0 and a.R == 1024
    assert (a.nv, a.Sc, a.has_weight) == (20, 7, 0)
    assert p.route == "shared" and p.mode == 0 and not p.track
    multi = dataclasses.replace(cfg, aggs=(port.AggSpec(
        "v", 0, 0, 15, -1000, 1000, sub_edges=chip_smoke.K4_MULTI),),
        track_outliers=True)
    a = port.DenseHistArgs.from_buffer_copy(
        port._hist_plan(multi, 1024, "0").tmpl)
    assert a.nsub == 2 and list(a.sub_span[:2]) == [50, 100]
    assert list(a.sub_off[:2]) == [0, 5] and a.span == 0
    assert port._plan("dense_hist", multi, 1024, "0", port._hist_plan) is \
        port._plan("dense_hist", multi, 1024, "0", port._hist_plan)
    with pytest.raises(ValueError):
        port._hist_plan(_hist_config(((0, 5),), 20, bs=0), 1024, "0")
    hcfg = port.ScanConfig(group_cols=("k0",), aggs=(), filters=(),
                           distinct_cols=("d",), key_bounds=((0, 5),),
                           hll=True)
    h = port._hll_plan(hcfg, 4096, "")
    a = port.HllArgs.from_buffer_copy(h.tmpl)
    assert (a.Sc, a.slots, a.R, h.shared, h.slots) == (7, 128, 4096, 1, 128)
    with pytest.raises(ValueError):
        port._hll_plan(hcfg, 2 ** 31, "")
