"""K16's corner cases in the port against the JAX reference, on the CPU.

One owner's received rows, made with numpy from a seed by chip_smoke.py's
k16_case_rows (the card runs the same cases through the kernels), go
through the port's shuffle_keys, sort_rows, shuffle_reduce and
shuffle_unpack (their plain versions here) and through the reference's
_segment_reduce and _unpack_payload, jitted on the CPU: no live row at
WP 174, every row live with one key, live rows whose keys are all
INT64_MAX tied with dead rows, segments past the merge cap, three keys
with MISSING values, a segment of 5,000 sorted rows.  Tolerance 0: every
merged word, live flag, group count, key, lane, bucket and meta word."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sybil_tpu.ops import scan as ref
from sybil_tpu.parallel import mesh as ref_mesh
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.parallel import mesh as port_mesh

SEGMENT_REDUCE = jax.jit(ref_mesh._segment_reduce, static_argnums=(0, 3))

CASES = [(case, shape) for case, (shapes, _, _) in
         chip_smoke.K16_CASES.items() for shape in shapes]


def configs(shape: str):
    """-> (the reference's mesh config, the port's) of a K16 shape."""
    o = dict(chip_smoke.K16_SHAPES[shape])
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o["aggs"])
    cfg = ref.ScanConfig(no_compact_table=True, **o)
    return cfg, port.config_from_fields(dataclasses.asdict(cfg))


@pytest.mark.parametrize("case,shape", CASES)
def test_k16_corner_case_matches_reference(case, shape):
    _, N, cap = chip_smoke.K16_CASES[case]
    cfg, pcfg = configs(shape)
    K, A, hist_ais, _, _, WP = port_mesh.payload_spec(pcfg)
    rows = chip_smoke.k16_case_rows(case, K, WP, N, seed=11)
    live = (rows[:, K] > 0) | (rows[:, K + 1] > 0)
    tied = live & (rows[:, :K] == chip_smoke.I64_MAX).all(axis=1)

    merged, mlive, ng = SEGMENT_REDUCE(cfg, jnp.asarray(rows),
                                       jnp.asarray(live), cap)
    trows = torch.from_numpy(rows)
    front, src, off = port_mesh.shuffle_keys(pcfg, trows[None])
    # the live rows and each tile's first dead row, in row order
    kept = src.numpy()
    assert set(np.flatnonzero(live)) <= set(kept) and \
        (np.diff(kept) > 0).all() and off.tolist() == [0, len(kept)]
    assert len(kept) - int(live.sum()) <= -(-N // port_mesh._KEYS_TILE)
    order = port.sort_rows(pcfg, front)
    pm = torch.empty((1, cap, WP), dtype=torch.int64)
    pl = torch.empty((1, cap), dtype=torch.int32)
    pstats = torch.zeros((1, port_mesh.n_stats(pcfg)), dtype=torch.int64)
    port_mesh.shuffle_reduce(pcfg, trows[None], src, order, off, pm, pl,
                             pstats)
    pm, pl, png = pm[0], pl[0], pstats[0, 0]
    np.testing.assert_array_equal(pm.numpy(), np.asarray(merged))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(mlive))
    assert int(png) == int(ng)
    if case == "segments past cap":
        assert int(ng) > cap
    if case == "INT64_MAX keys tied with dead rows":
        assert tied.any() and (~live).any()

    # two owners' tables gathered, compacted (lax.top_k's order) and
    # unpacked into a table of S rows, past the live rows
    flat = torch.cat([pm, torch.roll(pm, 5, 0)])
    flive = torch.cat([pl, torch.roll(pl, 5, 0)])
    S = cap + cap // 2
    k = min(S, flat.shape[0])
    top = port.topk_rows(flive, k, two_valued=True)
    _, want_top = jax.lax.top_k(jnp.asarray(flive.numpy()), k)
    np.testing.assert_array_equal(top.numpy(), np.asarray(want_top))
    rng = np.random.default_rng(5)
    stats = rng.integers(0, 50, (2, port_mesh.n_stats(pcfg)))
    stats[:, 0] = int(ng)
    un = port_mesh.shuffle_unpack(pcfg, flat, flive, top,
                                  torch.from_numpy(stats), S)
    ftop = flat.numpy()[top.numpy()]
    table = np.zeros((S, WP), np.int64)
    table[:k] = ftop
    tlive = np.zeros(S, bool)
    tlive[:k] = flive.numpy()[top.numpy()] != 0
    ucfg = dataclasses.replace(cfg, max_groups=S) \
        if cfg.strategy != "dense" else cfg
    want = ref_mesh._unpack_payload(
        ucfg, jnp.asarray(table), jnp.asarray(tlive), 2 * int(ng),
        int(stats[:, 1].sum()), int(stats[:, 2].sum()))
    meta = un["meta"].numpy()
    np.testing.assert_array_equal(meta[3:], stats[:, 3:].sum(axis=0))
    assert meta[0] == 2 * int(ng) == int(want["num_groups"])
    assert meta[1] == int(want["spill"])
    assert meta[2] == int(want["shuffle_overflow"]) + max(2 * int(ng) - S, 0)
    np.testing.assert_array_equal(un["keys"].numpy(),
                                  np.asarray(want["keys"]))
    sums = un["sums"].numpy()
    np.testing.assert_array_equal(sums[:S, 0], np.asarray(want["count"]))
    np.testing.assert_array_equal(sums[:S, 1], np.asarray(want["samples"]))
    np.testing.assert_array_equal(sums[S], 0)
    for ai in range(A):
        np.testing.assert_array_equal(sums[:S, 2 + 3 * ai] > 0,
                                      np.asarray(want[f"agg{ai}_exists"]))
        for j, key in ((3, "count"), (4, "wv")):
            np.testing.assert_array_equal(sums[:S, j + 3 * ai],
                                          np.asarray(want[f"agg{ai}_{key}"]))
        np.testing.assert_array_equal(un["mins"].numpy()[:, ai],
                                      np.asarray(want[f"agg{ai}_min"]))
        np.testing.assert_array_equal(un["maxs"].numpy()[:, ai],
                                      np.asarray(want[f"agg{ai}_max"]))
    m = min(S, cfg.dense_slots)       # the reference's hist holds its slots
    for h, ai in zip(un["hists"], hist_ais):
        wh = np.asarray(want[f"agg{ai}_hist"])
        np.testing.assert_array_equal(h.numpy()[:m], wh[:m])
        np.testing.assert_array_equal(wh[m:], 0)


# the owner loop over every local owner at once (merge_owners: one
# shuffle_keys, the K + 1 sorts, one shuffle_reduce) against the
# reference's _segment_reduce owner by owner: Dl owners of one K16 case's
# rows each (seeds apart), some owners replaced by an all-dead one
# (random words, count and samples 0) or an empty one (all zero, as the
# exchange leaves a block no shard filled)
STACKED = [(Dl, case, shape) for Dl, case, shape in (
    (8, "INT64_MAX keys tied with dead rows", "narrow"),
    (8, "segments past cap", "wide"),
    (2, "INT64_MAX keys tied with dead rows", "wide"),
    (2, "MISSING keys", "three keys"),
)]


def stacked_rows(Dl: int, case: str, K: int, WP: int, N: int):
    """[Dl, N, WP]: owner d the case's rows of seed 11 + d, but for owner
    1 (all dead) and the last (empty); with Dl 8 owners 2 and 4 take the
    rows of "every row live, one key" (no dead row at all) and "no live
    row"."""
    out = np.stack([chip_smoke.k16_case_rows(case, K, WP, N, seed=11 + d)
                    for d in range(Dl)])
    out[1, :, K:K + 2] = 0
    out[-1] = 0
    if Dl == 8:
        out[2] = chip_smoke.k16_case_rows("every row live, one key", K, WP,
                                          N, seed=2)
        out[4] = chip_smoke.k16_case_rows("no live row", K, WP, N, seed=4)
    return out


@pytest.mark.parametrize("Dl,case,shape", STACKED)
def test_stacked_owner_loop_matches_reference(Dl, case, shape):
    _, N, cap = chip_smoke.K16_CASES[case]
    cfg, pcfg = configs(shape)
    K, A, _, _, _, WP = port_mesh.payload_spec(pcfg)
    recv = stacked_rows(Dl, case, K, WP, N)
    merged = torch.full((Dl, cap, WP), 7, dtype=torch.int64)
    flive = torch.full((Dl, cap), 7, dtype=torch.int32)
    stats = torch.full((Dl, port_mesh.n_stats(pcfg)), 7, dtype=torch.int64)
    port_mesh.merge_owners(pcfg, torch.from_numpy(recv), merged, flive,
                           stats)
    tied_owners = 0
    for d in range(Dl):
        rows = recv[d]
        live = (rows[:, K] > 0) | (rows[:, K + 1] > 0)
        tied = live & (rows[:, :K] == chip_smoke.I64_MAX).all(axis=1)
        tied_owners += bool(tied.any())
        m, ml, ng = SEGMENT_REDUCE(cfg, jnp.asarray(rows), jnp.asarray(live),
                                   cap)
        np.testing.assert_array_equal(merged[d].numpy(), np.asarray(m))
        np.testing.assert_array_equal(flive[d].numpy(), np.asarray(ml))
        assert int(stats[d, 0]) == int(ng)
    assert (stats[:, 1:] == 7).all()          # only word 0 is K16's
    if "tied" in case:
        assert 0 < tied_owners < Dl


# K12's two-valued form (the mesh's compaction), on the flags chip_smoke.py
# runs through the kernel on the card: the plain version against
# lax.top_k of the int32 flags, index for index
@pytest.mark.parametrize("case", list(chip_smoke.K12_CASES))
def test_two_valued_compaction_matches_lax_top_k(case):
    flags, k = chip_smoke.k12_case(case)
    R = flags.shape[0]
    assert 1 <= k <= R and set(np.unique(flags)) <= {0, 1}
    got = port.topk_rows(torch.from_numpy(flags), k, two_valued=True)
    _, want = jax.lax.top_k(jnp.asarray(flags), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ones = int(flags.sum())
    # the live rows in index order, then the dead ones, cut at k
    order = np.concatenate([np.flatnonzero(flags), np.flatnonzero(flags == 0)])
    np.testing.assert_array_equal(got.numpy(), order[:k])
    if "above" in case or "+ 1" in case:
        assert k == ones + 1
    if "many tiles" in case:
        assert R > 4 * port.TOPK_TV_TILE


def test_two_valued_compaction_takes_only_int32():
    for dtype in (torch.int64, torch.float32, torch.bool):
        with pytest.raises(ValueError, match="int32"):
            port.topk_rows(torch.ones(8, dtype=dtype), 3, two_valued=True)
    # the general form takes int64 scores
    assert port.topk_rows(torch.arange(8), 3).tolist() == [7, 6, 5]
