"""Port dense scan (K2 + K3 plain versions) against the JAX reference.

The same numpy batch goes through sybil_tpu.ops.scan.scan_packed_jit and
sybil_tpu_torch.ops.scan.scan_packed (CPU tensors); the packed download
buffer `main` must agree word for word.  The port's ScanConfig is built
from the reference's field dict (config_from_fields)."""

import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sybil_tpu.ops import scan as ref
from sybil_tpu_torch.ops import scan as port

B, C = 3, 1024

# name -> (group key bounds, n aggs, weight, vbias, i32, extra)
CASES = {
    "g0-a1": ([], 1, False, False, False, {}),
    "g1-a1-missing": ([(0, 5)], 1, False, False, False, {}),
    "g1-a2-weight": ([(0, 5)], 2, True, False, False, {}),
    "g2-a2-vbias": ([(0, 5), (0, 4)], 2, False, True, False, {}),
    "g2-a1-vbias-i32": ([(0, 5), (-3, 9)], 1, False, True, True, {}),
    "g3-a3-weight-i32": ([(0, 5), (0, 3), (10, 6)], 3, True, True, True, {}),
    "g3-a2-negative-keys": ([(-4, 6), (0, 2), (-1, 3)], 2, False, False,
                            False, {}),
    "near-8192-slots": ([(0, 90), (0, 89)], 1, True, False, False, {}),
    "g-plus-1-is-slots": ([(0, 126)], 2, False, True, True, {}),
    "spill": ([(0, 3), (0, 4)], 1, False, False, False, {"spill": True}),
    "partial-blocks": ([(0, 5)], 2, True, False, False, {"partial": True}),
    "nrows-lanes-skipped": ([(0, 5)], 2, False, True, True,
                            {"nrows": True}),
}


def _make(name):
    """-> (reference ScanConfig, {col: (values, valid)} numpy, nrec)."""
    bounds, A, weight, vbias, i32, extra = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    R = B * C
    cols = {}
    groups = []
    for i, (mn, card) in enumerate(bounds):
        # the spill case draws keys one past the declared bound
        hi = card + 1 if extra.get("spill") else card
        v = rng.integers(mn, mn + hi, R).astype(np.int64)
        m = rng.random(R) < 0.9                   # MISSING rows
        cols[f"k{i}"] = (v.reshape(B, C), m.reshape(B, C))
        groups.append(f"k{i}")
    aggs = []
    for a in range(A):
        lo, hi = -50 * a, 200 + 100 * a
        v = rng.integers(lo - 20, hi + 40, R).astype(np.int64)
        full = extra.get("nrows")
        m = np.ones(R, bool) if full else rng.random(R) < 0.85
        cols[f"v{a}"] = (v.reshape(B, C), m.reshape(B, C))
        # discard bounds cut both tails (the reference's info.min /
        # info.max*10 window)
        aggs.append(ref.AggSpec(f"v{a}", hist_min=lo, bucket_size=0,
                                num_values=0, discard_min=lo,
                                discard_max=hi))
    wmax = 1
    if weight:
        v = rng.integers(0, 101, R).astype(np.int64)
        m = rng.random(R) < 0.8
        cols["w"] = (v.reshape(B, C), m.reshape(B, C))
        wmax = 100
    bias = tuple(a.discard_min for a in aggs) if vbias else ()
    rb, nrows = (), ()
    if i32:
        rb = [wmax, 1]
        for a in aggs:
            rb += [1, wmax, wmax * (a.discard_max - a.discard_min)]
        rb = tuple(rb)
    if extra.get("nrows"):
        nrows = [not weight, True]
        for _ in aggs:
            nrows += [True, not weight, False]
        nrows = tuple(nrows)
    cfg = ref.ScanConfig(group_cols=tuple(groups), aggs=tuple(aggs),
                         filters=(), weight_col="w" if weight else "",
                         key_bounds=tuple(bounds), agg_vbias=bias,
                         lane_row_bounds=rb, lane_nrows=nrows)
    nrec = np.full(B, C, dtype=np.int32)
    if extra.get("partial"):
        nrec[:] = [0, 700, 1]
    return cfg, cols, nrec


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_packed_main_matches_reference(name):
    cfg, cols, nrec = _make(name)
    assert cfg.strategy == "dense"
    packed, _ = ref.scan_packed_jit(
        cfg, {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
              cols.items()},
        jnp.asarray(nrec), jnp.zeros((0,), jnp.int64), (),
        jnp.asarray(1, jnp.int64), {})
    want = np.asarray(packed["main"])
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    ppacked, raw = port.scan_packed(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec))
    got = ppacked["main"].numpy()
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    spilled = int(want[0, 1])
    assert (spilled > 0) == bool(CASES[name][5].get("spill"))
    assert raw["sums"].shape[0] == port.reduce_space(pcfg)[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_layout_matches_reference(name):
    cfg, _, _ = _make(name)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    assert pcfg == port.ScanConfig(**{
        **dataclasses.asdict(cfg),
        "aggs": tuple(port.AggSpec(**dataclasses.asdict(a))
                      for a in cfg.aggs)})
    for R in (B * C, 128 * 65536):
        assert pcfg.dense_slots == cfg.dense_slots
        assert pcfg.strategy == cfg.strategy
        assert port.main_width(pcfg) == ref.main_width(cfg)
        assert port.table_prefix(pcfg) == ref.table_prefix(cfg)
        assert port.packed_layout(pcfg, R) == ref.packed_layout(cfg, R)
        assert port.dense_table_plan(pcfg, R) == ref.dense_table_plan(cfg, R)
        np.testing.assert_array_equal(port.dense_keys_np(pcfg, 1),
                                      ref.dense_keys_np(cfg, 1))


@pytest.mark.parametrize("what", ["filters", "time", "hist", "distinct",
                                  "samples", "sorted"])
def test_unported_shapes_raise(what):
    cfg, cols, nrec = _make("g1-a1-missing")
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    # Each case carried a part that was not ported; all are now, and each
    # equals the reference's `main` word for word: set filters (B6b, over
    # a set-column CSR of three entries a row, row i holding i % 7, i % 5
    # and 2), samples (A13, with its matched mask), the sorted strategy's
    # device prune (B10: a time rollup and a forced sorted scan under
    # prune_topk) and count distinct (B9: the distinct pairs, with and
    # without a histogram)
    def change(c):
        return {
            "filters": {"filters": (port.FilterSpec("k0", "in", "set"),)},
            "time": {"time_col": "k0", "prune_topk": 1000},
            "hist": {"aggs": (dataclasses.replace(c.aggs[0], num_values=10,
                                                  bucket_size=25),),
                     "force_sorted": True, "distinct_cols": ("v0",)},
            "distinct": {"distinct_cols": ("v0",)},
            "samples": {"want_matched_mask": True},
            "sorted": {"force_sorted": True, "prune_topk": 1000},
        }[what]
    item = {"filters": "B6b", "time": "B10", "hist": "B9", "distinct": "B9",
            "samples": "A13", "sorted": "B10"}[what]
    bad = dataclasses.replace(pcfg, **change(pcfg))
    assert what in ("filters", "distinct", "samples") or \
        bad.strategy == "sorted"
    tcols = {k: (torch.from_numpy(v), torch.from_numpy(m))
             for k, (v, m) in cols.items()}
    R = B * C
    fv = np.zeros(0, np.int64)
    ref_aux, port_aux = {}, {}
    if item == "B6b":
        fv = np.array([4], np.int64)
        prow = np.repeat(np.arange(R, dtype=np.int32), 3)
        pval = np.stack([np.arange(R) % 7, np.arange(R) % 5,
                         np.full(R, 2)], 1).reshape(-1).astype(np.int64)
        ref_aux = {"k0": (jnp.asarray(prow), jnp.asarray(pval))}
        port_aux = {"k0": (torch.from_numpy(prow), torch.from_numpy(pval),
                           len(prow))}
    rcfg = dataclasses.replace(cfg, **change(cfg))
    packed, out = ref.scan_packed_jit(
        rcfg, {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
               cols.items()},
        jnp.asarray(nrec), jnp.asarray(fv), (), jnp.asarray(1, jnp.int64),
        ref_aux)
    got, raw = port.scan_packed(bad, tcols, torch.from_numpy(nrec),
                                torch.from_numpy(fv), (), 1, port_aux)
    np.testing.assert_array_equal(got["main"].numpy(),
                                  np.asarray(packed["main"]))
    meta = np.asarray(packed["main"])[0]
    if item == "B10":
        assert int(meta[4]) > 0                     # pruned
    elif item == "B9":
        assert int(meta[2 + len(port.hist_aggs(bad))]) > 0   # npairs
    elif item == "B6b":
        # rows i with i % 7 == 4 or i % 5 == 4 pass
        assert int(raw["sums"][:, 1].sum()) == int(
            ((np.arange(R) % 7 == 4) | (np.arange(R) % 5 == 4)).sum())
    else:
        np.testing.assert_array_equal(raw["matched"].numpy(),
                                      np.asarray(out["matched"]))
        assert raw["matched"].numpy().all()


@pytest.mark.parametrize("n", [0, 5, port._DESC_HEAD, port._DESC_HEAD + 40])
def test_descriptor_block_head_and_device_copy(n):
    """_set_desc points each field at its first word: byte offsets into
    the kernel parameters' head while the block fits it, else pointers
    into a device copy of the whole block, whose host words match."""
    words = [(-1) ** i * (i * 0x9E3779B97F4A7C15 % 2**62) for i in range(n)]
    split = n // 3
    a = port.SortedFrontArgs()
    port._set_desc(a, torch.device("cpu"),
                   {"pack_min": words[:split], "pack_card": words[split:]})
    assert a.desc.n == n
    assert list(a.desc.head[:min(n, port._DESC_HEAD)]) == \
        words[:port._DESC_HEAD]
    base = a.desc.dev or 0
    assert (base != 0) == (n > port._DESC_HEAD) == bool(a.desc.host)
    if base:
        host = (ctypes.c_longlong * n).from_address(a.desc.host)
        assert list(host) == words
        assert a.desc_keep[1].numel() == n
    assert (a.pack_min or 0) - base == 0
    assert (a.pack_card or 0) - base == 8 * split


_SCAN_DENSE = jax.jit(ref._scan_dense, static_argnums=(0,))


@functools.partial(jax.jit, static_argnums=(0,))
def _ref_gid(cfg, cols, nrec, fv, tb):
    """The reference's reduce-space gid of every row (dead rows slots-1)."""
    _, _, _, _, matched, keys, _, _ = ref._front_end(cfg, cols, nrec, fv, (),
                                                     tb, {})
    return ref._dense_gid(cfg, keys, matched, tb)[0]


# the table each limit case of K2_CASES puts the shared form in
_K2_ROUTES = {"per-warp tables at their limit": "warp",
              "a table a CTA past the per-warp limit": "cta",
              "a table a CTA at the shared limit": "cta",
              "global tables past the shared limit": "global",
              "a windowed table at the resident limit": "resident"}


@pytest.mark.parametrize("name", list(chip_smoke.K2_CASES))
def test_dense_scan_case_matches_reference(name):
    """K2 on chip_smoke.py's K2 cases (the card holds the kernel's shared,
    global and windowed forms to the plain version on the same cases):
    dense_scan_plain against the reference's jitted _scan_dense (the sums
    of every live slot, the min/max, the spill count, the matched mask)
    and its _dense_gid (the gid of every row, the dead slot remapped to
    Sc-1 in the compact reduce space).  Tolerance 0."""
    fields, cols, nrec, fvals, tb, _ = chip_smoke.k2_case(name, 2, 2048)
    o = dict(fields)
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o["aggs"])
    o["filters"] = tuple(ref.FilterSpec(*f, -1) for f in o["filters"])
    cfg = ref.ScanConfig(**o)
    pcfg = chip_smoke.k2w_config(port, fields)
    assert port.config_from_fields(dataclasses.asdict(cfg)) == pcfg
    assert cfg.strategy == "dense"
    if name in _K2_ROUTES:
        assert port.dense_scan_route(pcfg) == _K2_ROUTES[name]
    jcols = {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in
             cols.items()}
    jargs = (jnp.asarray(nrec), jnp.asarray(fvals))
    want = _SCAN_DENSE(cfg, jcols, *jargs, (), jnp.asarray(tb, jnp.int64),
                       {})
    got = port.dense_scan_plain(
        pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
               for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fvals), (), tb)
    slots, Sc, compact = port.reduce_space(pcfg)
    n = Sc - 1                         # the live rows of both tables
    sums = got["sums"].numpy()
    count = np.asarray(want["count"])
    np.testing.assert_array_equal(sums[:n, 0], count[:n])
    np.testing.assert_array_equal(sums[:n, 1],
                                  np.asarray(want["samples"])[:n])
    assert not count[n:].any()
    hist = port.hist_aggs(pcfg)
    for ai in range(len(cfg.aggs)):
        np.testing.assert_array_equal(sums[:n, 2 + 3 * ai] > 0,
                                      np.asarray(want[f"agg{ai}_exists"])[:n])
        np.testing.assert_array_equal(sums[:n, 3 + 3 * ai],
                                      np.asarray(want[f"agg{ai}_count"])[:n])
        np.testing.assert_array_equal(sums[:n, 4 + 3 * ai],
                                      np.asarray(want[f"agg{ai}_wv"])[:n])
        if ai in hist:
            j = hist.index(ai)
            np.testing.assert_array_equal(got["mins"][:n, j].numpy(),
                                          np.asarray(want[f"agg{ai}_min"])[:n])
            np.testing.assert_array_equal(got["maxs"][:n, j].numpy(),
                                          np.asarray(want[f"agg{ai}_max"])[:n])
    spill = int(want["spill"])
    assert int(got["spill"][0]) == spill
    assert (spill > 0) == ("spill" in name)
    if cfg.want_matched_mask:
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(want["matched"]))
    if got["gid"] is not None:
        gid = np.asarray(_ref_gid(cfg, jcols, *jargs,
                                  jnp.asarray(tb, jnp.int64)))
        if compact:
            gid = np.where(gid == slots - 1, Sc - 1, gid)
        np.testing.assert_array_equal(got["gid"].numpy(), gid)
    live = sums[:n, 1] > 0
    if name == "every row of a warp on one gid":
        assert live.sum() == 1
    if name == "32 gids a warp":
        assert live.sum() == 32
