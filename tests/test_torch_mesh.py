"""The mesh scan (-data-shards) in the port against the JAX reference, on
the CPU.

Batch level: the plain versions of K15 (the payload rows, the key hash,
the placement, the dense slot-key decode), K16 (the owner's merge and the
unpack) and K12's two-valued compaction are held word for word against
sybil_tpu.parallel.mesh's _build_payload, _mix_keys, _partition_rows,
_segment_reduce and _unpack_payload on the same inputs; the port's
sharded_scan at D = 8 against sybil_tpu.parallel.mesh.sharded_scan on
conftest's 8-device CPU mesh, word for word for every merged output and
row-level side output and for the packed download (pack_jit against
pack_parts: K5, K3's keyed form or K10), at the shapes of the
reference's multichip dry run (__graft_entry__.dryrun_multichip: hist
with outliers, a time rollup, distinct pairs, a set filter, the samples
mask, the skewed top-k under the device prune), dense forms of them, and
a table past its group cap (the shuffle overflow).  Query level:
tests/test_sharded.py's cases run through both CLIs and run_query with
-data-shards 8: the port prints the reference's sharded bytes (text and
-json) and its own unsharded answer; an overflowing shuffle is refused.

Tolerance 0 everywhere (counts, sums, keys, buckets, printed bytes),
except where a sharded answer merges float means in another order than
the unsharded one: there the JSON values agree within 1e-12 relative."""

import contextlib
import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sybil_tpu import cli as ref_cli
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.ops import scan as ref
from sybil_tpu.parallel import mesh as ref_mesh
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch import cli as port_cli
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.debug import SybilError
from sybil_tpu_torch.ops import scan as port
from sybil_tpu_torch.parallel import mesh as port_mesh
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, QueryParams
from sybil_tpu_torch.table import Table

D = 8
B, C = 2 * D, 256
R = B * C
HIST = dict(hist_min=0, bucket_size=10, num_values=14, discard_min=0,
            discard_max=1400)
AVG = dict(hist_min=0, bucket_size=1, num_values=0, discard_min=-10 ** 9,
           discard_max=10 ** 9)

# name -> (ScanConfig fields, batch options, filter constants, time
# bucket, set filter); the first six are dryrun_multichip's shapes
CASES = {
    "hist-outliers": (dict(group_cols=("host",), aggs=(("ping", HIST),),
                           filters=(("ping", "gt", "int"),),
                           weight_col="weight", max_groups=1024,
                           track_outliers=True), {}, [30], 1, False),
    "time-rollup": (dict(group_cols=("host",), aggs=(("ping", AVG),),
                         time_col="time", max_groups=4096), {}, [], 500,
                    False),
    "distinct-pairs": (dict(group_cols=("host",), distinct_cols=("user",),
                            max_groups=4096), {}, [], 1, False),
    "set-filter": (dict(group_cols=("host",),
                        filters=(("tags", "in", "set"),), max_groups=4096),
                   {}, [3], 1, True),
    "samples-mask": (dict(group_cols=("host",),
                          filters=(("tags", "in", "set"),), max_groups=4096,
                          want_matched_mask=True), {}, [3], 1, True),
    "zipf-topk-prune": (dict(group_cols=("host",), aggs=(("ping", AVG),),
                             max_groups=8192, prune_topk=64, prune_agg=-1),
                        dict(card=4096, zipf=True), [], 1, False),
    "dense-hist-outliers": (dict(group_cols=("host",), aggs=(("ping", HIST),),
                                 filters=(("ping", "gt", "int"),),
                                 weight_col="weight", track_outliers=True,
                                 key_bounds=((0, 5),)), {}, [30], 1, False),
    "dense-rollup": (dict(group_cols=("host",), aggs=(("ping", AVG),),
                          time_col="time", key_bounds=((0, 10), (0, 5))),
                     {}, [], 500, False),
    "dense-two-keys-set": (dict(group_cols=("host", "user"),
                                aggs=(("ping", HIST), ("weight", AVG)),
                                filters=(("tags", "nin", "set"),),
                                key_bounds=((0, 5), (0, 37)),
                                want_matched_mask=True), {}, [2], 1, True),
    "sorted-hist-pairs": (dict(group_cols=("host", "user"),
                               aggs=(("ping", HIST),), max_groups=2048,
                               force_sorted=True), {}, [], 1, False),
    "group-cap-overflow": (dict(group_cols=("host",), aggs=(("ping", AVG),),
                                max_groups=512),
                           dict(card=4096), [], 1, False),
}


def make_batch(card=5, zipf=False, seed=7):
    """dryrun_multichip's batch: host keys (uniform or zipf), ping with 5%
    missing, weights, times, users; and the set column's CSR, global and
    per shard (local row ids, pads at R_local), as the engine builds
    them."""
    rng = np.random.default_rng(seed)
    if zipf:
        g = (rng.zipf(1.3, (B, C)) % card).astype(np.int64)
    else:
        g = rng.integers(0, card, (B, C)).astype(np.int64)
    cols = {
        "host": (g, np.ones((B, C), bool)),
        "ping": (np.abs(rng.normal(60, 20, (B, C))).astype(np.int64),
                 rng.random((B, C)) > 0.05),
        "weight": (rng.choice([1, 10, 100], (B, C)).astype(np.int64),
                   np.ones((B, C), bool)),
        "time": (rng.integers(0, 5000, (B, C)).astype(np.int64),
                 np.ones((B, C), bool)),
        "user": (rng.integers(0, 37, (B, C)).astype(np.int64),
                 np.ones((B, C), bool)),
    }
    R_local = R // D
    g_rows = np.arange(0, R, 3, dtype=np.int64)
    per = [g_rows[(g_rows >= d * R_local) & (g_rows < (d + 1) * R_local)]
           - d * R_local for d in range(D)]
    m = 128
    while m < max(len(p) for p in per):
        m *= 2
    prow = np.full((D, m), R_local, dtype=np.int32)
    pval = np.full((D, m), -2, dtype=np.int64)
    for d, p in enumerate(per):
        prow[d, :len(p)] = p
        pval[d, :len(p)] = (p + d * R_local) % 7
    return cols, (prow, pval, tuple(len(p) for p in per))


def make_config(name):
    fields, *_ = CASES[name]
    o = dict(fields)
    o["aggs"] = tuple(ref.AggSpec(c, **kw) for c, kw in o.get("aggs", ()))
    o["filters"] = tuple(ref.FilterSpec(*f) for f in o.get("filters", ()))
    # the engine's mesh config: the keyed table on the wire
    return ref.ScanConfig(no_compact_table=True, **o)


_REF_MESH = None


def ref_mesh_8():
    global _REF_MESH
    if _REF_MESH is None:
        assert len(jax.devices()) >= D, "conftest must force 8 cpu devices"
        _REF_MESH = ref_mesh.make_mesh(D)
    return _REF_MESH


def run_both(name):
    """-> (cfg, pcfg, ref out, ref packed, port parts, port packed)."""
    _, bopts, fvals, tb, with_set = CASES[name]
    cfg = make_config(name)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    cols, (prow, pval, ns) = make_batch(**bopts)
    nrec = np.full(B, C, np.int32)
    nrec[3] = C - 40           # a short block
    fv = np.asarray(fvals, np.int64)
    jsa = {"tags": (jnp.asarray(prow), jnp.asarray(pval))} if with_set \
        else {}
    out = ref_mesh.sharded_scan(
        cfg, ref_mesh_8(), {k: (jnp.asarray(v), jnp.asarray(m))
                            for k, (v, m) in cols.items()},
        jnp.asarray(nrec), jnp.asarray(fv), (), jnp.asarray(tb, jnp.int64),
        jsa)
    packed = ref.pack_jit(cfg, out, R)
    tsa = {"tags": (torch.from_numpy(prow), torch.from_numpy(pval), ns)} \
        if with_set else {}
    parts = port_mesh.sharded_scan(
        pcfg, port_mesh.Mesh(D),
        {k: (torch.from_numpy(v), torch.from_numpy(m))
         for k, (v, m) in cols.items()}, torch.from_numpy(nrec),
        torch.from_numpy(fv), (), tb, tsa)
    return cfg, pcfg, out, packed, parts, port.pack_parts(pcfg, parts)


def merged_view(pcfg, parts) -> dict:
    """The port's merged parts under the reference's out names."""
    table = parts["k2"] if pcfg.strategy == "dense" else parts["k8"]
    meta = parts["meta"].numpy()
    S = pcfg.table_slots
    sums = table["sums"].numpy()[:S]
    out = {"num_groups": meta[0], "spill": meta[1],
           "shuffle_overflow": meta[2], "keys": table["keys"].numpy(),
           "count": sums[:, 0], "samples": sums[:, 1]}
    for ai in range(len(pcfg.aggs)):
        out[f"agg{ai}_exists"] = sums[:, 2 + 3 * ai] > 0
        out[f"agg{ai}_count"] = sums[:, 3 + 3 * ai]
        out[f"agg{ai}_wv"] = sums[:, 4 + 3 * ai]
        out[f"agg{ai}_min"] = table["mins"].numpy()[:, ai]
        out[f"agg{ai}_max"] = table["maxs"].numpy()[:, ai]
    for i, ai in enumerate(port.hist_aggs(pcfg)):
        if pcfg.track_outliers:
            out[f"agg{ai}_nout"] = meta[3 + i]
        if pcfg.strategy == "dense":
            out[f"agg{ai}_hist"] = parts["raw"][f"agg{ai}_hist"].numpy()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_scan_matches_reference(name):
    cfg, pcfg, out, packed, parts, ppacked = run_both(name)
    assert pcfg.strategy == ("dense" if name.startswith("dense")
                             else "sorted")
    got = merged_view(pcfg, parts)
    for key, want in got.items():
        np.testing.assert_array_equal(want, np.asarray(out[key]),
                                      err_msg=key)
    raw = parts["raw"]
    for ai in port.hist_aggs(pcfg):
        if pcfg.track_outliers:
            for key in ("out_mask", "out_val"):
                np.testing.assert_array_equal(
                    raw[f"agg{ai}_{key}"].numpy(),
                    np.asarray(out[f"agg{ai}_{key}"]))
        if pcfg.strategy != "dense":
            for key in ("hp_mask", "hp_bv", "hp_w", "hp_keys"):
                np.testing.assert_array_equal(
                    raw[f"agg{ai}_{key}"].numpy(),
                    np.asarray(out[f"agg{ai}_{key}"]))
    if pcfg.distinct_cols:
        np.testing.assert_array_equal(raw["pair_mask"].numpy(),
                                      np.asarray(out["pair_mask"]))
        np.testing.assert_array_equal(
            torch.cat([raw["kmat"], raw["dmat"]], 1).numpy(),
            np.asarray(out["sorted_keys"]))
    if pcfg.want_matched_mask:
        np.testing.assert_array_equal(raw["matched"].numpy(),
                                      np.asarray(out["matched"]))
    np.testing.assert_array_equal(ppacked["main"].numpy(),
                                  np.asarray(packed["main"]))
    if "table" in ppacked:
        np.testing.assert_array_equal(ppacked["table"].numpy(),
                                      np.asarray(packed["table"]))
    assert (got["shuffle_overflow"] > 0) == (name == "group-cap-overflow")
    assert got["num_groups"] > 0


def test_multichip_parities():
    """dryrun_multichip's two parity checks on the port: the distinct
    pair set and the matched row count equal the unsharded scan's."""
    for name, key in (("distinct-pairs", "pair_mask"),
                      ("samples-mask", "matched")):
        _, bopts, fvals, tb, with_set = CASES[name]
        cfg = dataclasses.replace(make_config(name), no_compact_table=False)
        pcfg = port.config_from_fields(dataclasses.asdict(cfg))
        cols, (prow, pval, ns) = make_batch(**bopts)
        nrec = torch.full((B,), C, dtype=torch.int32)
        tcols = {k: (torch.from_numpy(v), torch.from_numpy(m))
                 for k, (v, m) in cols.items()}
        sa = {}
        if with_set:
            rows = [prow[d, :n] + d * (R // D) for d, n in enumerate(ns)]
            vals = [pval[d, :n] for d, n in enumerate(ns)]
            p1, v1 = port_engine_csr(np.concatenate(rows),
                                     np.concatenate(vals))
            sa = {"tags": (p1, v1, sum(ns))}
        _, raw1 = port.scan_packed(pcfg, tcols, nrec,
                                   torch.tensor(fvals, dtype=torch.int64),
                                   (), tb, sa)
        parts = port_mesh.sharded_scan(
            dataclasses.replace(pcfg, no_compact_table=True),
            port_mesh.Mesh(D), tcols, nrec,
            torch.tensor(fvals, dtype=torch.int64), (), tb,
            {"tags": (torch.from_numpy(prow), torch.from_numpy(pval), ns)}
            if with_set else {})
        rawm = parts["raw"]
        if key == "pair_mask":
            def pairs(r):
                sk = torch.cat([r["kmat"], r["dmat"]], 1)[r["pair_mask"]]
                return {tuple(x) for x in sk.tolist()
                        if port.SENTINEL not in x}
            assert pairs(rawm) == pairs(raw1) and len(pairs(raw1)) > 100
        else:
            assert int(rawm["matched"].sum()) == int(raw1["matched"].sum())


def port_engine_csr(rows, vals):
    from sybil_tpu_torch.query.engine import pad_set_csr
    p, v = pad_set_csr(rows, vals, R)
    return torch.from_numpy(p), torch.from_numpy(v)


# ---------------------------------------------------------------------------
# the plain kernels against the reference's pieces
# ---------------------------------------------------------------------------

def test_k15_pieces_match_reference():
    """K15's plain version: the payload (dense: the decoded slot keys and
    the expanded reduce space), the key hash and the placement, against
    _build_payload, _mix_keys and _partition_rows on one shard's table."""
    for name in ("dense-hist-outliers", "dense-rollup", "sorted-hist-pairs"):
        _, bopts, fvals, tb, _ = CASES[name]
        cfg = make_config(name)
        pcfg = port.config_from_fields(dataclasses.asdict(cfg))
        cols, _ = make_batch(**bopts)
        Bs = B // D
        sc = {k: (v[:Bs], m[:Bs]) for k, (v, m) in cols.items()}
        nrec = np.full(Bs, C, np.int32)
        fv = np.asarray(fvals, np.int64)
        out = ref.scan_batch(cfg, {k: (jnp.asarray(v), jnp.asarray(m))
                                   for k, (v, m) in sc.items()},
                             jnp.asarray(nrec), jnp.asarray(fv), (),
                             jnp.asarray(tb, jnp.int64), {})
        Seff, Sc = port_mesh.shuffle_caps(pcfg, D)
        payload, live = jax.jit(ref_mesh._build_payload,
                                static_argnums=(0, 2))(cfg, out, Seff)
        part = port.scan_core(pcfg, {k: (torch.from_numpy(v),
                                         torch.from_numpy(m))
                                     for k, (v, m) in sc.items()},
                              torch.from_numpy(nrec), torch.from_numpy(fv),
                              (), tb, {})
        ppay, plive = port_mesh.build_payload_plain(pcfg, part)
        np.testing.assert_array_equal(ppay.numpy(), np.asarray(payload))
        np.testing.assert_array_equal(plive.numpy(), np.asarray(live))
        K = pcfg.n_key_cols
        h = port_mesh.mix_keys_plain(ppay[:, :K])
        np.testing.assert_array_equal(
            h.numpy(), np.asarray(ref_mesh._mix_keys(payload[:, :K]))
            .astype(np.int64))
        # a per-owner capacity of 4 rows: the two wide tables overflow
        send, overflow = ref_mesh._partition_rows(payload, live,
                                                  payload[:, :K], D, 4)
        stats = torch.zeros((1, port_mesh.n_stats(pcfg)), dtype=torch.int64)
        psend = port_mesh.shuffle_partition(pcfg, [part], D, 4, stats)
        np.testing.assert_array_equal(psend[0].numpy(), np.asarray(send))
        assert int(stats[0, 2]) == int(overflow)
        assert (int(overflow) > 0) == (name in ("dense-rollup",
                                                "sorted-hist-pairs"))


@pytest.mark.parametrize("cap", ["shuffle caps", "4 rows"])
@pytest.mark.parametrize("Dl", [8, 2])
@pytest.mark.parametrize("name", ["dense-rollup", "sorted-hist-pairs"])
def test_k15_batched_matches_reference(name, Dl, cap):
    """K15 over a process's Dl local shards in one call (sharded_scan's
    form), shard by shard against _build_payload and _partition_rows on
    the same shard's reference scan: the send buffers word for word, the
    overflow and spill words.  Shard 3 has no record (no live row); a
    per-owner capacity of 4 rows overflows."""
    _, bopts, fvals, tb, _ = CASES[name]
    cfg = make_config(name)
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    K = pcfg.n_key_cols
    cols, _ = make_batch(**bopts)
    Bs = B // D
    nrec = np.full(B, C, np.int32)
    nrec[3 * Bs:4 * Bs] = 0
    fv = np.asarray(fvals, np.int64)
    Seff, Sc = port_mesh.shuffle_caps(pcfg, D)
    if cap == "4 rows":
        Sc = 4
    # the shards of process 1 of 4 (Dl 2) or of the only process, shard
    # 3 among them
    shards = range(2, 4) if Dl == 2 else range(8)
    build = jax.jit(ref_mesh._build_payload, static_argnums=(0, 2))
    want, parts = [], []
    for d in shards:
        blk = slice(d * Bs, (d + 1) * Bs)
        sc = {k: (v[blk], m[blk]) for k, (v, m) in cols.items()}
        out = ref.scan_batch(cfg, {k: (jnp.asarray(v), jnp.asarray(m))
                                   for k, (v, m) in sc.items()},
                             jnp.asarray(nrec[blk]), jnp.asarray(fv), (),
                             jnp.asarray(tb, jnp.int64), {})
        payload, live = build(cfg, out, Seff)
        send, overflow = ref_mesh._partition_rows(payload, live,
                                                  payload[:, :K], D, Sc)
        want.append((np.asarray(send), int(overflow), int(out["spill"]),
                     int(np.asarray(live).sum())))
        parts.append(port.scan_core(
            pcfg, {k: (torch.from_numpy(v), torch.from_numpy(m))
                   for k, (v, m) in sc.items()},
            torch.from_numpy(nrec[blk]), torch.from_numpy(fv), (), tb, {}))
    stats = torch.zeros((Dl, port_mesh.n_stats(pcfg)), dtype=torch.int64)
    got = port_mesh.shuffle_partition(pcfg, parts, D, Sc, stats)
    assert tuple(got.shape) == (Dl, D, Sc, port_mesh.payload_spec(pcfg)[-1])
    for i, (send, overflow, spill, nlive) in enumerate(want):
        np.testing.assert_array_equal(got[i].numpy(), send)
        assert int(stats[i, 2]) == overflow and int(stats[i, 1]) == spill
    nlive = [w[3] for w in want]
    assert nlive[list(shards).index(3)] == 0 and max(nlive) > 0
    assert (sum(w[1] for w in want) > 0) == (cap == "4 rows")


def test_dense_slot_keys_match_reference():
    """K15's and K3's slot-key decode (dense_keys_np's formula) against
    _dense_decode_keys, MISSING digits and the time key included."""
    cfg = make_config("dense-rollup")
    pcfg = port.config_from_fields(dataclasses.asdict(cfg))
    want = np.asarray(ref._dense_decode_keys(cfg, jnp.asarray(500,
                                                              jnp.int64)))
    np.testing.assert_array_equal(port.dense_keys_np(pcfg, 500), want)
    assert (want[:, 1] == -1).any() and (want[:, 0] % 500 == 0).all()


def test_k16_and_compaction_match_reference():
    """K16's plain versions (the sort operands, the owner's merge, the
    unpack) and K12's two-valued compaction against _segment_reduce, the
    lax.top_k compaction and _unpack_payload, on received rows with
    duplicate keys, dead rows and MISSING keys, past the merge cap."""
    rng = np.random.default_rng(3)
    for name in ("dense-hist-outliers", "sorted-hist-pairs",
                 "time-rollup"):
        cfg = make_config(name)
        pcfg = port.config_from_fields(dataclasses.asdict(cfg))
        K, A, hist_ais, nv_total, n_sum, WP = port_mesh.payload_spec(pcfg)
        N, cap = 600, 150
        rows = rng.integers(-5, 50, (N, WP)).astype(np.int64)
        rows[:, :K] = rng.integers(-1, 400 if K == 1 else 40, (N, K))
        rows[rng.random(N) < 0.2, K:K + 2] = 0          # dead rows
        live = (rows[:, K] > 0) | (rows[:, K + 1] > 0)
        merged, mlive, ng = jax.jit(ref_mesh._segment_reduce,
                                    static_argnums=(0, 3))(
            cfg, jnp.asarray(rows), jnp.asarray(live), cap)
        trows = torch.from_numpy(rows)[None]
        front, src, off = port_mesh.shuffle_keys(pcfg, trows)
        assert off.tolist() == [0, int(live.sum()) + 1]   # one dead row
        order = port.sort_rows(pcfg, front)
        pm = torch.empty((1, cap, WP), dtype=torch.int64)
        pl = torch.empty((1, cap), dtype=torch.int32)
        pstats = torch.zeros((1, 3), dtype=torch.int64)
        port_mesh.shuffle_reduce(pcfg, trows, src, order, off, pm, pl,
                                 pstats)
        pm, pl, png = pm[0], pl[0], pstats[0, 0]
        np.testing.assert_array_equal(pm.numpy(), np.asarray(merged))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(mlive))
        assert int(png) == int(ng) > cap
        # two owners' tables gathered, then compacted and unpacked
        flat = torch.cat([pm, torch.roll(pm, 7, 0)])
        flive = torch.cat([pl, torch.roll(pl, 7, 0)])
        S = 256
        top = port.topk_rows(flive, min(S, flive.numel()), two_valued=True)
        _, want_top = jax.lax.top_k(jnp.asarray(flive.numpy()), S)
        np.testing.assert_array_equal(top.numpy(), np.asarray(want_top))
        stats = torch.tensor([[int(ng), 1, 2] + [0] * (2 * len(
            port.hist_aggs(pcfg)))] * 2, dtype=torch.int64)
        un = port_mesh.shuffle_unpack(pcfg, flat, flive, top, stats, S)
        ftop = flat.numpy()[top.numpy()]
        table = np.zeros((S, WP), np.int64)
        table[:len(ftop)] = ftop
        tlive = np.zeros(S, bool)
        tlive[:len(ftop)] = flive.numpy()[top.numpy()] != 0
        ucfg = dataclasses.replace(cfg, max_groups=S) \
            if cfg.strategy != "dense" else cfg
        want = ref_mesh._unpack_payload(ucfg, jnp.asarray(table),
                                        jnp.asarray(tlive), 2 * int(ng), 2,
                                        4)
        assert int(un["meta"][0]) == 2 * int(ng)
        assert int(un["meta"][2]) == 4 + max(2 * int(ng) - S, 0)
        np.testing.assert_array_equal(un["keys"].numpy(),
                                      np.asarray(want["keys"]))
        for ai in range(A):
            np.testing.assert_array_equal(
                un["sums"].numpy()[:S, 2 + 3 * ai] > 0,
                np.asarray(want[f"agg{ai}_exists"]))
            for j, key in ((3, "count"), (4, "wv")):
                np.testing.assert_array_equal(
                    un["sums"].numpy()[:S, j + 3 * ai],
                    np.asarray(want[f"agg{ai}_{key}"]))
            np.testing.assert_array_equal(un["mins"].numpy()[:, ai],
                                          np.asarray(want[f"agg{ai}_min"]))
            np.testing.assert_array_equal(un["maxs"].numpy()[:, ai],
                                          np.asarray(want[f"agg{ai}_max"]))
        for h, ai in zip(un["hists"], hist_ais):
            np.testing.assert_array_equal(
                h.numpy()[:cfg.dense_slots],
                np.asarray(want[f"agg{ai}_hist"]))
        np.testing.assert_array_equal(un["sums"].numpy()[:S, 0],
                                      np.asarray(want["count"]))
        np.testing.assert_array_equal(un["sums"].numpy()[S], 0)


def test_keyed_dense_table_of_an_unsharded_scan():
    """K3's keyed form of an unsharded scan's own table (no_compact_table
    without a merged table: the row-store scan's) packs the reference's
    words (scan_packed_jit), with the keys decoded from each slot (a time
    key at digit 0 included); a merged table without no_compact_table is
    still refused."""
    for name in ("dense-hist-outliers", "dense-rollup",
                 "dense-two-keys-set"):
        _, bopts, fvals, tb, has_set = CASES[name]
        cfg = make_config(name)
        pcfg = port.config_from_fields(dataclasses.asdict(cfg))
        cols, (prow, pval, nent) = make_batch(**bopts)
        tcols = {k: (torch.from_numpy(v), torch.from_numpy(m))
                 for k, (v, m) in cols.items()}
        nrec = np.full(B, C, np.int32)
        nrec[-1] = C // 3
        fv = np.asarray(fvals, np.int64)
        ref_aux, port_aux = {}, {}
        if has_set:
            # the global CSR: every shard's rows, moved to batch rows
            R_local = R // D
            rws = np.concatenate([prow[d, :n] + d * R_local
                                  for d, n in enumerate(nent)])
            vls = np.concatenate([pval[d, :n] for d, n in enumerate(nent)])
            m = 128
            while m < len(rws):
                m *= 2
            grow = np.full(m, R, np.int32)
            gval = np.full(m, -2, np.int64)
            grow[:len(rws)], gval[:len(vls)] = rws, vls
            ref_aux = {"tags": (jnp.asarray(grow), jnp.asarray(gval))}
            port_aux = {"tags": (torch.from_numpy(grow),
                                 torch.from_numpy(gval), len(rws))}
        want, _ = ref.scan_packed_jit(
            cfg, {k: (jnp.asarray(v), jnp.asarray(m))
                  for k, (v, m) in cols.items()},
            jnp.asarray(nrec), jnp.asarray(fv), (),
            jnp.asarray(tb, jnp.int64), ref_aux)
        got, _ = port.scan_packed(pcfg, tcols, torch.from_numpy(nrec),
                                  torch.from_numpy(fv), (), tb, port_aux)
        np.testing.assert_array_equal(got["main"].numpy(),
                                      np.asarray(want["main"]))
        K = pcfg.n_key_cols
        keyed = got["main"].numpy()[1:1 + pcfg.dense_slots]
        live = (keyed[:, K] > 0) | (keyed[:, K + 1] > 0)
        assert live.sum() == got["main"].numpy()[0, 0] > 0
        if has_set:
            continue
        parts = port_mesh.sharded_scan(pcfg, port_mesh.Mesh(D), tcols,
                                       torch.from_numpy(nrec),
                                       torch.from_numpy(fv), (), tb, {})
        flat = dataclasses.replace(pcfg, no_compact_table=False)
        lay = port.packed_layout(flat, R)
        main = torch.empty((lay["rows"], lay["W"]), dtype=torch.int64)
        with pytest.raises(ValueError, match="needs no_compact_table"):
            port.dense_pack_plain(flat, parts["k2"], parts["hists"],
                                  parts["nouts"], main, R)


# ---------------------------------------------------------------------------
# query level: tests/test_sharded.py's cases through both engines
# ---------------------------------------------------------------------------

HOSTS = ["a.com", "b.com", "c.com", "d.com", "e.com"]


def _uptime_columns(n, seed):
    rng = np.random.default_rng(seed)
    ints = {"ping": rng.integers(0, 100, n).astype(np.int64),
            "weight": rng.choice([1, 10], n).astype(np.int64),
            "index_int": np.arange(n, dtype=np.int64),
            "time": (1_700_000_000 + rng.integers(0, 30 * 86400, n))
            .astype(np.int64)}
    strs = {"host": [HOSTS[i] for i in rng.integers(0, 5, n)],
            "status": [str(s) for s in rng.choice([200, 404, 500], n)]}
    sets = [[f"mod{k}" for k in (2, 3, 5) if i % k == 0] for i in range(n)]
    return ints, strs, sets


@pytest.fixture(scope="module")
def uptime(tmp_path_factory):
    """test_sharded's table: 3,000 rows in blocks of 256 (12 blocks, 8 a
    batch), with a set column; written by the reference."""
    import sybil_tpu.digest as ref_digest
    d = str(tmp_path_factory.mktemp("mesh") / "db")
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 256
    try:
        t = RefTable("uptime", RefFlags(dir=d, table="uptime"))
        ints, strs, sets = _uptime_columns(3000, 5)
        t.ingest_columns(ints=ints, strs=strs, sets={"groups": sets})
    finally:
        ref_digest.CHUNK_SIZE = old
    return d


def _run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None), argv
    return buf.getvalue()


# name -> query argv past -dir/-table (tests/test_sharded.py 48-233)
QUERIES = {
    "group-avg": ["-group", "host", "-int", "ping", "-op", "avg"],
    "filters-weight": ["-group", "host,status", "-weight-col", "weight",
                       "-int-filter", "ping:gt:40",
                       "-str-filter", r"host:re:\.com"],
    "hist": ["-group", "status", "-int", "ping", "-op", "hist"],
    "time-rollup": ["-group", "host", "-time", "-time-bucket", "604800",
                    "-time-col", "time"],
    "distinct": ["-group", "host", "-distinct", "status"],
    "set-filter": ["-group", "host", "-set-filter", "groups:in:mod3"],
    "samples": ["-samples", "-limit", "5", "-int-filter", "ping:gt:90"],
    "hist-loghist-outliers": ["-group", "host", "-int", "ping", "-op",
                              "hist", "-loghist"],
}


@pytest.mark.parametrize("json_out", [False, True])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sharded_query_matches_reference(uptime, name, json_out,
                                         monkeypatch):
    argv = ["query", "-dir", uptime, "-table", "uptime",
            "-device-batch", "8"] + QUERIES[name] + (["-json"] if json_out
                                                     else [])
    shard = ["-data-shards", "8"]
    calls = []
    real = port_mesh.sharded_scan

    def spy(cfg, mesh, *args):
        calls.append((mesh.D, cfg.no_compact_table))
        return real(cfg, mesh, *args)

    monkeypatch.setattr(port_mesh, "sharded_scan", spy)
    want = _run_cli(ref_cli.main, argv + shard)
    got = _run_cli(port_cli.main, argv + shard + ["-device", "cpu"])
    assert got == want
    assert calls and set(calls) == {(8, True)}
    n = len(calls)
    plain = _run_cli(port_cli.main, argv + ["-device", "cpu"])
    assert len(calls) == n          # the unsharded query takes no mesh
    if name == "samples":
        # the sample list is read in block order either way
        assert plain == got
    elif json_out:
        _assert_json_close(json.loads(got), json.loads(plain))
    else:
        assert sorted(got.splitlines()) == sorted(plain.splitlines()) or \
            _float_lines_close(got, plain)


def _assert_json_close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_json_close(a[k], b[k])
    elif isinstance(a, list):
        key = lambda x: json.dumps(x, sort_keys=True)  # noqa: E731
        if all(isinstance(x, dict) for x in a):
            a, b = sorted(a, key=key), sorted(b, key=key)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_json_close(x, y)
    elif isinstance(a, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12)
    else:
        assert a == b


def _float_lines_close(a: str, b: str) -> bool:
    la, lb = sorted(a.splitlines()), sorted(b.splitlines())
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        for u, v in zip(x.split(), y.split()):
            if u == v:
                continue
            try:
                if not math.isclose(float(u), float(v), rel_tol=1e-12):
                    return False
            except ValueError:
                return False
    return True


def _zipf_table(d, n, users, seed, hist=False):
    """30% of the rows on 5 hot users, the rest spread over `users`, in
    blocks of 4,096 rows (written by the reference)."""
    import sybil_tpu.digest as ref_digest
    rng = np.random.default_rng(seed)
    uid = np.where(rng.random(n) < 0.3, rng.integers(0, 5, n),
                   rng.integers(0, users, n)).astype(np.int64)
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = 4096
    try:
        t = RefTable("zipf", RefFlags(dir=d, table="zipf"))
        t.ingest_columns(ints={"uid": uid,
                               "v": rng.integers(0, 800 if hist else 1000,
                                                 n).astype(np.int64),
                               "time": np.arange(n, dtype=np.int64)})
    finally:
        ref_digest.CHUNK_SIZE = old


@pytest.mark.parametrize("case", ["highcard-zipf", "hist-12k-groups",
                                  "cache-mode"])
def test_sharded_run_query_matches_reference(tmp_path, case):
    """test_sharded's large cases at a smaller size: a skewed group-by
    past the dense caps, a sparse-hist query of 12,000 groups (past the
    reference's 10k capacity case; no group cap lowered), and the cache
    mode's per-group pipeline under a mesh (written, then hit)."""
    d = str(tmp_path / "db")
    if case == "cache-mode":
        return _cache_mode_case(tmp_path)
    hist = case == "hist-12k-groups"
    _zipf_table(d, 90_000 if hist else 60_000, 12_000 if hist else 20_000,
                11, hist)
    op = "hist" if hist else "avg"
    rp = RefParams(groups=("uid",), aggs=(RefAgg("v", op),), prune_by="")
    pp = QueryParams(groups=("uid",), aggs=(AggDef("v", op),), prune_by="")
    rf = RefFlags(dir=d, table="zipf", device_batch=8, max_groups=30000,
                  data_shards=8)
    pf = Flags(dir=d, table="zipf", device_batch=8, max_groups=30000,
               data_shards=8, device="cpu")
    want = ref_run_query(RefTable("zipf", rf), rp, rf)
    got = run_query(Table("zipf", pf), pp, pf)
    plain = run_query(Table("zipf", pf), pp,
                      dataclasses.replace(pf, data_shards=0))
    assert len(want.results) > 5000
    for other in (want, plain):
        assert set(got.results) == set(other.results)
        for k, r in other.results.items():
            g = got.results[k]
            assert (g.count, g.samples) == (r.count, r.samples), k
            gh, rh = g.hists["v"], r.hists["v"]
            assert gh.total_count() == rh.total_count()
            assert math.isclose(gh.mean(), rh.mean(), rel_tol=1e-12)
            if hist:
                np.testing.assert_array_equal(gh.values, rh.values)


def _cache_mode_case(tmp_path):
    import sybil_tpu.digest as ref_digest
    import sybil_tpu.query.cache as ref_cache
    from sybil_tpu_torch.query import cache as port_cache
    olds = (ref_digest.CHUNK_SIZE, ref_cache.CHUNK_SIZE,
            port_cache.CHUNK_SIZE)
    ref_digest.CHUNK_SIZE = ref_cache.CHUNK_SIZE = 256
    port_cache.CHUNK_SIZE = 256
    try:
        d = str(tmp_path / "db")
        rng = np.random.default_rng(2)
        n = 256 * 20
        t = RefTable("shc", RefFlags(dir=d, table="shc"))
        t.ingest_columns(
            ints={"ping": (np.arange(n) % 90).astype(np.int64),
                  "time": np.arange(n, dtype=np.int64)},
            strs={"host": [f"h{i % 5}" for i in rng.permutation(n)]})
        argv = ["query", "-dir", d, "-table", "shc", "-group", "host",
                "-int", "ping", "-op", "avg", "-json", "-device-batch",
                "64"]
        base = _run_cli(ref_cli.main, argv)
        cache = argv + ["-data-shards", "8", "-cache-queries"]
        port_cache.HITS = port_cache.MISSES = 0
        wrote = _run_cli(port_cli.main, cache + ["-device", "cpu"])
        assert port_cache.MISSES > 0
        hit = _run_cli(port_cli.main, cache + ["-device", "cpu"])
        assert port_cache.HITS > 0
    finally:
        (ref_digest.CHUNK_SIZE, ref_cache.CHUNK_SIZE,
         port_cache.CHUNK_SIZE) = olds
    for out in (wrote, hit):
        _assert_json_close(json.loads(out), json.loads(base))


def test_shuffle_overflow_is_refused(tmp_path):
    """More merged groups than table slots: the meta row's overflow word
    is set and the engine refuses the answer, as the reference does."""
    d = str(tmp_path / "db")
    _zipf_table(d, 20_000, 5000, 4)
    pf = Flags(dir=d, table="zipf", device_batch=8, max_groups=1000,
               data_shards=8, device="cpu")
    pp = QueryParams(groups=("uid",), aggs=(AggDef("v", "avg"),),
                     prune_by="")
    with pytest.raises(SybilError, match="shuffle overflowed by"):
        run_query(Table("zipf", pf), pp, pf)
    rf = RefFlags(dir=d, table="zipf", device_batch=8, max_groups=1000,
                  data_shards=8)
    with pytest.raises(Exception, match="shuffle overflowed by"):
        ref_run_query(RefTable("zipf", rf),
                      RefParams(groups=("uid",), aggs=(RefAgg("v", "avg"),),
                                prune_by=""), rf)
