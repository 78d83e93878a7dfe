"""A/B timings of checkouts of this package on the card: kernels, and
warm query walls.

    python sybil_tpu_torch/k2_ab.py ROOT [ROOT ...]
    python sybil_tpu_torch/k2_ab.py --trace ROOT
    python sybil_tpu_torch/k2_ab.py --walls DIR ROOT [ROOT ...]

Each ROOT is a directory holding a `sybil_tpu_torch` package, such as
the repo itself or an unpacked parent commit; a fresh process imports
that package and builds its kernels.  Give the roots in turns (parent,
change, change, parent) to compare two versions on one card.

Kernels (the first form): over synthetic 8,388,608-row batches shaped
like config 1 (`group by host, avg ping`) and config 3 (`status eq 200,
group by host, hist ping`): K2 on both shapes, K3 after each, K5 on
config 3's shape with outliers tracked (no live outlier row, as on the
bench table), and the sorted strategy on config 3's filter with a
packed key: K7, K8 and K10 (`avg ping`); for a root that has K14,
K14 and K2 at config 1's shape with one set filter (1 or 2 entries a
row) and the matched mask, timed beside the same launch without them;
and for a root with the query cache's cache-group key, K2 at config 1's
shape with that key (8 groups of 16 blocks) and K7 unpacked at config
3's filter with and without it; for a root with the mesh scan, K16's
shuffle_reduce at config 3 -loghist's and path 2's owner shapes (1,024
rows of WP 174, none live; 201,024 rows of WP 9, 9,108 live) and
shuffle_unpack at their final tables (128 and 100,000 rows); K2's
windowed form at config 4's shape (`group by action, avg weight` at 1 h
buckets over four weeks: 6,784 slots) in its three layouts (the rows
time-sorted, sorted in 1,000,000-row runs as bulk ingests write them,
and in arrival order), and K12's two-valued form at the mesh's
compactions of config 3 -loghist (int32 [1,024], k 128) and path 2
([201,024], k 100,000).
CUDA events over 20 launches
(K3, K5 and K10 200), twice: back to back as a caller issues them
("wall", which includes the wrapper's host time whenever that exceeds
the kernel's), and behind a sleep kernel long enough that the host has
queued them all before the first starts ("device", the kernels' own
time); and the host's time a call, a host clock over 100 calls queued
behind a sleep kernel ("host").

K6 and K8 (both roots): K6's id mode at row 9's shape (128 blocks of
65,536 str ids) and its value mode on the same rows as int32 deltas,
then at each other delta type (uint8, uint16, int8, int16, int64), each
width beside its torch call (an int64 cumsum plus the base, and the
bit-unpack); K8 at path 2's shape (two unpacked int64 lanes, about 72,576 groups),
path 1's (an int32 packed key and a min/max lane), the distinct pairs'
(K + D = 3 lanes) and the cache-group form's.

K15 and the device prune (both roots): K15 over a whole mesh batch, 8
shards each scanned by scan_core, at config 3 -loghist's shape (128
table rows a shard, WP 174) and path 2's (100,000 rows, about 9,070
live, Sc 25,128, WP 9), as the root runs it (one call a shard, or one
call over the 8), beside the two torch calls that place the same rows (a
stable argsort of the owners keyed shard x 9 + owner, an index_copy_);
the sorted device prune at config 5's shape: K12 alone over 100,000
int64 scores (k 1,000), the select and the gather as the root runs them
(two calls, or prune_topk_gather's one), and table[pidx].

K12 and K16 (`--only K12,K16`; a root without the mesh times K12
alone): K12's general form at config 5's enumerated shape (a
partition's 4,194,304 K11 scores: -1, or a user's row count at the end
of its segment; and the f32 mean weights of -prune-sort weight), k
1,000, and at the sorted device prune's 100,000 slots alone and with its
gather, each beside torch.topk; a mesh batch's owner loop (8 owners:
shuffle_keys, the sorts and shuffle_reduce, as the root runs them: one
call over the owners, or one an owner) at config 3 -loghist's and path
2's shapes (on a root whose shuffle_keys packs the sort key, also with
the K + 1 lanes sorted instead, then packed again), beside its torch
calls (the masked transpose of every owner's keys and the stable sorts
by owner and key); and K16's and K12's two-valued runs above.

K1 and K2 (`--only K1,K2`): K1 at row 1's shape (128 v2 blocks of
65,536 rows of config 1's `ping` and of `host`), the same `ping` launch
with every row a missing block (the zeroing alone) and row 10's (128 v1
edge blocks); K2's shared form at config 1's shape (also with 500 hosts,
with a set filter and the mask beside the same launch without them, and
with the cache-group key of group_avg: 8 groups of 16 blocks), config
3's and config 2's (`action neq pageload, weight gt 5, group by action,
page, hist weight`: 91 compact slots), its global form forced at config
1's and config 3's shapes, and the windowed form's three config-4
layouts beside the global form forced on each.

K7 and sort_permute (`--only K7,sort_permute`): K7 at path 1 (config 3
-tdigest: an int32 packed key after one filter), path 2 (config 4 at 300
s buckets: two int64 lanes), the distinct lanes (K + D = 3), the
cache-group lane of group_tdigest, S3 with and without its set filter,
S4b with and without the matched mask, config 5's enum form (4,194,304
rows) and one mesh shard of path 2 (1,048,576 rows); sort_permute at
path 2's step (no base), the distinct pairs' second step (a base) and
path 2's mesh owner (201,024 rows), each beside its torch call, and path
2's gather with p the identity and with p a random permutation.  With
`--trace`, first the atomics and ptxas registers of each kernel of the
sorted_front library; each sort_permute run also prints how often a row's
source shares its predecessor's 32-byte sector, and the ascending runs
of p.

K3 and K10 with their second entries (`--only
K3,K10,enum_pack,dense_keyed`, pack_runs): K3 at config 1 (7 compact
slots), config 3 with its gid and bucket sections, the device HLL's 8
planes and a mesh's merged keyed table (config 3 -loghist, 128 rows,
outliers tracked); dense_keyed at a -read-log pseudo-block (65,536 rows,
128 slots, Sc 9); K10 at path 1 (its 8,192-row pair section), path 2,
the distinct pairs (a 16,384-row section), the device prune at config
5's 100,000 slots and a mesh batch's merged table (path 2's); enum_pack
at config 5 (4,194,304 rows, 1,000 winners).  `--only B5` (b5_runs):
K9's two entries, the stable sort of the pair key between them and K11
at their main-path shapes, the wrappers that bind their C entry once;
with K5 also selected, K5 over path 1's sorted keys (kmat) with
outliers tracked (no live row).  With `--trace`, `--only B5` or `K5`
first prints the atomics and ptxas registers of each kernel of the
hist_pairs and outlier_compact libraries.

K11 (`--only K11`, k11_runs): K11 at config 5's shape (a partition's
4,194,304 rows, userid zipf(1.2) % 200,000, after K7's enum form and the
sort), by $COUNT and by -prune-sort weight's f32 mean, beside its torch
call (index_add_ of the prebuilt lanes by segment).  With `--trace`,
`--only K6,K11` first prints the atomics and ptxas registers of each
kernel of the decode_value and enum_segments libraries.

K4 and K13 (`--only K4,K13`, hist_hll_runs): K4 at config 3, config 3
-loghist, config 2 and chip_smoke.py's global-table edge batch after
K2's gid; K13 with the int hash (a distinct
index a row) and the str hash (5 status ids) at `group by host` (7
planes) and at 126 groups (128 planes); each label gives the table, the
route and the grid the root takes.  With `--trace`, first the atomics
and ptxas registers of each kernel of the dense_hist and hll_registers
libraries.

`--only K6,K8` (before the roots) times only the runs whose label
starts with one of the prefixes and a non-digit (`--only K15,prune` the
runs above; K1 does not select K10).
With `--trace ROOT`, `--only` prints each selected run's wall and
device times, its host time a call (a host clock over 100 calls queued
behind a sleep kernel) and its device work a call as torch.profiler
records it;
with K1 or K2 selected, first the atomics and the ptxas registers of each
kernel of the decode_bucket2 and dense_scan libraries.

Trace (`--trace ROOT`): the atomic instructions each kernel of the
root's dense_scan and topk_rows libraries compiled to (cuobjdump -sass:
a 64-bit shared atomicAdd is a CAS spin loop, ATOMS.CAST.SPIN.64), and
the live-gid span and distinct gids of each 8,192-row chunk in the three
config-4 layouts that the kernel runs time; then each K6 and K8 run's
wall and device times and its device work a call as torch.profiler
records it (each kernel, copy and memset with its count and device
time), and for K8 its groups, how often a sorted row's source row shares
its predecessor's 32-byte sector, and the 4,096-row tile edges that cut
a segment.

Walls (`--walls`): builds chip_smoke.py's uptime table (8,388,608 rows,
bench.py's generator and seed) and its time-sorted user_sessions table
under DIR unless they are there, then for each root times `run_query` of
config 1, config 3 and path 2 warm (decoded columns resident), and for a
root with the mesh scan the same three at `-data-shards 8`: 15 queries
after 3 warm-ups, their median wall and quartiles, and the median of each
of the engine's phases over the same 15 queries.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 8_388_608


def _import_root(root: str):
    sys.path.insert(0, root)
    from sybil_tpu_torch.ops import kernels, scan
    if not scan.__file__.startswith(root):
        raise SystemExit(f"imported {scan.__file__}, not the one under "
                         f"{root}")
    kernels.build()
    return kernels, scan


def _ms(fn, iters=20, queued=False):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        # about 50 ms of cycles: long enough to queue 200 launches
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, iters=100) -> float:
    """The host's time a call of fn in µs: a host clock over `iters` calls
    queued behind a sleep kernel, so that none waits on the card."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return host


def kernel_runs(root: str, only=()) -> tuple:
    """(label, iterations, call) of every run of the root, or of those
    whose label starts with one of the prefixes `only`."""
    import numpy as np
    import torch

    _, scan = _import_root(root)
    dev = torch.device("cuda")

    def wanted(prefix: str) -> bool:
        # the runs whose inputs take seconds to build, only when selected
        return not only or prefix in only

    rng = np.random.default_rng(0)
    B, C = 128, 65536
    R = B * C

    def col(v, p_valid):
        return (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C))
                .to(dev),
                torch.from_numpy(rng.random(R) < p_valid).reshape(B, C)
                .to(dev))

    cols = {"host": col(rng.integers(0, 5, R), 0.93),
            "ping": col(np.abs(rng.normal(60, 20, R)).astype(np.int64),
                        0.89),
            "status": col(rng.integers(0, 5, R), 1.0)}
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    avg = scan.AggSpec("ping", 0, 0, 0, 0, 200)
    hist = scan.AggSpec("ping", 0, 1, 166, 0, 165)
    status = (scan.FilterSpec("status", "eq", "str"),)
    c1 = scan.ScanConfig(group_cols=("host",), aggs=(avg,), filters=(),
                         key_bounds=((0, 5),))
    c3 = scan.ScanConfig(group_cols=("host",), aggs=(hist,),
                         filters=status, key_bounds=((0, 5),))
    c3o = scan.ScanConfig(group_cols=("host",), aggs=(hist,),
                          filters=status, key_bounds=((0, 5),),
                          track_outliers=True)
    c7 = scan.ScanConfig(group_cols=("host",), aggs=(avg,), filters=status,
                         key_bounds=((0, 5),), force_sorted=True,
                         sort_pack=((0, 5),))
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    cols1 = {k: cols[k] for k in ("host", "ping")}

    def main_of(cfg):
        lay = scan.packed_layout(cfg, R)
        return lay, torch.zeros((lay["rows"], lay["W"]), dtype=torch.int64,
                                device=dev)

    k2c1 = scan.dense_scan(c1, cols1, nrec)
    _, main1 = main_of(c1)
    k2c3 = scan.dense_scan(c3, cols, nrec, fv)
    h3 = scan.dense_hist(c3, 0, cols, k2c3["gid"])
    _, main3 = main_of(c3)
    lay5, main5 = main_of(c3o)
    off5 = lay5["out0"][0]
    mask5 = torch.zeros(R, dtype=torch.bool, device=dev)
    val5 = cols["ping"][0].reshape(R)
    front7 = scan.sorted_front(c7, cols, nrec, fv)
    order7 = scan.sort_rows(c7, front7)
    k8 = scan.segment_reduce(c7, cols, front7, order7)
    _, main10 = main_of(c7)

    c1w = scan.ScanConfig(group_cols=("host",), aggs=(avg,), filters=(),
                          key_bounds=((0, 500),))
    cols1w = {"host": col(rng.integers(0, 500, R), 0.93),
              "ping": cols["ping"]}
    runs = (
        ("K2 config-1 shape", 20,
         lambda: scan.dense_scan(c1, cols1, nrec)),
        ("K2 config-3 shape", 20, lambda: scan.dense_scan(c3, cols, nrec, fv)),
        ("K2 config-1 shape, 500 hosts (fewer rows a slot)", 20,
         lambda: scan.dense_scan(c1w, cols1w, nrec)),
        ("K2 global form forced at config-1 shape", 20,
         lambda: scan.dense_scan(c1, cols1, nrec, form="global")),
        ("K2 global form forced at config-3 shape", 20,
         lambda: scan.dense_scan(c3, cols, nrec, fv, form="global")),
        ("K3 config-1 shape", 200,
         lambda: scan.dense_pack(c1, k2c1, [], [], main1, R)),
        ("K3 config-3 shape", 200,
         lambda: scan.dense_pack(c3, k2c3, [h3["hist"]], [h3["nout"]],
                                 main3, R)),
        ("K5 config-3 shape, no live outlier", 200,
         lambda: scan.outlier_compact(c3o, cols, mask5, val5, main5, off5)),
        ("K7 config-3 filter, packed key", 20,
         lambda: scan.sorted_front(c7, cols, nrec, fv)),
        ("K8 same", 20,
         lambda: scan.segment_reduce(c7, cols, front7, order7)),
        ("K10 same", 200,
         lambda: scan.sorted_pack(c7, k8, front7["spill"], [], [], main10,
                                  R)),
    )
    if hasattr(scan, "set_match"):
        import dataclasses

        from sybil_tpu_torch.query.engine import pad_set_csr
        k = rng.integers(1, 3, R)
        rows = np.repeat(np.arange(R, dtype=np.int32), k)
        prow, pval = pad_set_csr(rows, rng.integers(0, 4, len(rows)), R)
        csr = (torch.from_numpy(prow).to(dev), torch.from_numpy(pval).to(dev),
               len(rows))
        cs = dataclasses.replace(
            c1, filters=(scan.FilterSpec("groups", "in", "set"),),
            want_matched_mask=True)
        fvs = torch.tensor([1], dtype=torch.int64, device=dev)
        sm = scan.set_filter_masks(cs, fvs, {"groups": csr}, R)
        runs += (
            (f"K14 one set filter ({len(rows)} entries)", 20,
             lambda: scan.set_match(*csr, fvs, 0, R)),
            ("K2 config-1 shape with the set filter and the mask", 20,
             lambda: scan.dense_scan(cs, cols1, nrec, fvs, set_masks=sm)),
            ("K2 config-1 shape without them (the same launch)", 20,
             lambda: scan.dense_scan(c1, cols1, nrec)))
    if hasattr(scan, "has_cg"):
        import dataclasses

        # a query-cache group scan at config 1's and path 1's shapes: the
        # cache-group key (block // 16: 8 groups) ahead of host
        cg1 = dataclasses.replace(c1, group_cols=("__cg__", "host"),
                                  key_bounds=((0, B // 16), (0, 5)),
                                  vg_span=16)
        cg7 = dataclasses.replace(c7, group_cols=("__cg__", "host"),
                                  sort_pack=(), vg_span=16)
        c7u = dataclasses.replace(c7, sort_pack=())
        runs += (
            ("K2 config-1 shape with the cache-group key", 20,
             lambda: scan.dense_scan(cg1, cols1, nrec)),
            ("K7 config-3 filter, unpacked, with the cache-group key", 20,
             lambda: scan.sorted_front(cg7, cols, nrec, fv)),
            ("K7 the same without it", 20,
             lambda: scan.sorted_front(c7u, cols, nrec, fv)))
    if os.path.exists(os.path.join(root, "sybil_tpu_torch", "parallel",
                                   "mesh.py")):
        runs += k16_runs(dev)
        runs += c4_runs(scan, dev) + k12_runs(scan, dev)
        runs += k15_runs(scan, dev)
        if wanted("K16"):
            runs += owner_runs(scan, dev)
    if wanted("K12"):
        runs += k12g_runs(scan, dev)
    runs += k6_runs(dev) + k8_runs(scan, dev) + prune_runs(scan, dev)
    if not only or "K11" in only:
        runs += k11_runs(scan, dev)
    runs += c2_runs(scan, dev) + k1_runs(dev)
    runs += k7_runs(scan, dev) + permute_runs(scan, dev)
    if not only or any(o in only for o in PACK_PREFIXES):
        runs += pack_runs(scan, dev)
    if not only or "B5" in only:
        runs += b5_runs(scan, dev)
    if not only or "K4" in only or "K13" in only:
        runs += hist_hll_runs(scan, dev)
    if only:
        runs = tuple(r for r in runs if any(_selects(o, r[0]) for o in only))
    return runs


def _selects(prefix: str, label: str) -> bool:
    """Whether `--only` prefix selects the run `label`: K1 selects "K1
    v2 ..." but not "K10 ..."."""
    return label.startswith(prefix) and not label[len(prefix):][:1].isdigit()


def time_kernels(root: str, only=()) -> str:
    return f"{root}: " + "; ".join(
        f"{what} {_ms(fn, n):.4f} ms wall, "
        f"{_ms(fn, n, queued=True):.4f} ms device, {_host_us(fn):.1f} us host"
        for what, n, fn in kernel_runs(root, only))


def k16_owner(scan, mesh, dev, shape: str):
    """One owner's received rows and its merge's operands, shaped like
    chip_smoke's mesh queries at -data-shards 8: config 3 -loghist's
    owner (8 x 128 rows of WP 174, none live) or path 2's (8 x 25,128
    rows of WP 9: 9,108 live at the heads of the sources' blocks, 9,100
    distinct keys), and the final table's operands (the gathered merged
    tables, K12's order, the statistics rows) -> (config, the merge's
    arguments in the root's signature, the unpack's arguments)."""
    import numpy as np
    import torch

    sys.path.append(REPO)
    import chip_smoke
    o = dict(chip_smoke.K16_SHAPES["wide" if shape == "config 3" else
                                   "narrow"])
    o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o["aggs"])
    config = scan.ScanConfig(no_compact_table=True, **o)
    K, A, hist_ais, nv_total, n_sum, WP = mesh.payload_spec(config)
    rng = np.random.default_rng(1)
    D = 8
    Sc, nlive, ngroups, S = ((128, 0, 0, 128) if shape == "config 3" else
                             (25_128, 9_108, 9_100, 100_000))
    rows = np.zeros((D, Sc, WP), np.int64)
    keys = rng.choice(10 ** 9, (ngroups, K), replace=False) if ngroups \
        else np.zeros((0, K), np.int64)
    keys = np.concatenate([keys, keys[:nlive - ngroups]])
    per = np.array_split(np.arange(nlive), D)
    for d, idx in enumerate(per):
        blk = rows[d, :len(idx)]
        blk[:] = rng.integers(0, 1000, blk.shape)
        blk[:, :K] = keys[idx]
        blk[:, K] = rng.integers(1, 100, len(idx))
    rows_t = torch.from_numpy(rows.reshape(D * Sc, WP)).to(dev)
    merged = torch.empty((Sc, WP), dtype=torch.int64, device=dev)
    flive = torch.empty(Sc, dtype=torch.int32, device=dev)
    if hasattr(mesh, "merge_owners"):     # one call over stacked owners
        recv = rows_t[None]
        front, src, off = mesh.shuffle_keys(config, recv)
        order = scan.sort_rows(config, front)
        st = torch.zeros((1, mesh.n_stats(config)), dtype=torch.int64,
                         device=dev)
        red = (config, recv, src, order, off, merged[None], flive[None], st)
    else:
        got = mesh.shuffle_keys(config, rows_t)
        new = isinstance(got, tuple)      # shuffle_keys -> (keys, counts)
        skeys, counts = got if new else (got, None)
        order = scan.sort_rows(config, {"key": None, "keys": skeys})
        ng = torch.empty(1, dtype=torch.int64, device=dev)
        red = ((config, rows_t, order, counts, merged, flive, ng) if new
               else (config, rows_t, order, merged, flive, ng))
    flat = torch.from_numpy(rng.integers(0, 1000, (D * Sc, WP))).to(dev)
    fl = np.zeros((D, Sc), np.int32)
    for d, idx in enumerate(np.array_split(np.arange(ngroups or 5), D)):
        fl[d, :len(idx)] = 1
    flive_all = torch.from_numpy(fl.reshape(-1)).to(dev)
    top = scan.topk_rows(flive_all, min(S, D * Sc), two_valued=True)
    stats = torch.zeros((D, mesh.n_stats(config)), dtype=torch.int64,
                        device=dev)
    return config, red, (config, flat, flive_all, top, stats, S)


def k16_runs(dev) -> tuple:
    """K16's reduce and unpack at config 3 -loghist's and path 2's owner
    shapes (k16_owner)."""
    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.parallel import mesh
    runs = ()
    for shape in ("config 3", "path 2"):
        _, red, un = k16_owner(scan, mesh, dev, shape)
        runs += ((f"K16 shuffle_reduce at {shape}'s owner", 50,
                  lambda red=red: mesh.shuffle_reduce(*red)),
                 (f"K16 shuffle_unpack at {shape}'s final table", 50,
                  lambda un=un: mesh.shuffle_unpack(*un)))
    return runs


def c4_runs(scan, dev) -> tuple:
    """K2's windowed form at config 4's shape (bench_configs.py:143-155:
    activity_generator's times over four weeks, 9 actions, weights of 1,
    10 and 100; 1 h buckets) in three layouts of the same rows: sorted by
    time (a digested table), sorted in 1,000,000-row runs (bulk
    ingests), and unsorted (arrival order)."""
    import dataclasses

    import torch
    B, C = 128, 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(42)
    now, month, tb = 1_755_000_000, 4 * 7 * 86400, 3600
    t = now - torch.randint(0, month, (R,), device=dev, generator=g)
    runs_ = t.clone()
    for lo in range(0, R, 1_000_000):
        runs_[lo:lo + 1_000_000] = torch.sort(runs_[lo:lo + 1_000_000])[0]
    action = torch.randint(0, 9, (R,), device=dev, generator=g)
    weight = torch.tensor([1, 10, 100], device=dev)[
        torch.randint(0, 3, (R,), device=dev, generator=g)]
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    qmin = (now - month + 1) // tb
    cfg = scan.ScanConfig(
        group_cols=("action",), aggs=(scan.AggSpec("weight", 0, 0, 0, 1,
                                                   100),),
        filters=(), time_col="time",
        key_bounds=((qmin, now // tb - qmin + 1), (0, 9)), window=128,
        window_chunk=8192, time_i32=True, agg_vbias=(1,))
    out = ()
    # the bind's window: 128 slots for time-sorted blocks, 896 for blocks
    # that span the four weeks (tests/test_torch_rollup.py's layouts)
    for label, tv, window in (("time-sorted", torch.sort(t)[0], 128),
                              ("bulk", runs_, 128),
                              ("arrival order", t, 896)):
        cols = {"time": (tv.reshape(B, C), valid),
                "action": (action.reshape(B, C), valid),
                "weight": (weight.reshape(B, C), valid)}
        wcfg = dataclasses.replace(cfg, window=window)
        out += ((f"K2 windowed at config 4, {label}", 20,
                 lambda cols=cols, wcfg=wcfg: scan.dense_scan(
                     wcfg, cols, nrec, None, (), tb, form="windowed")),
                (f"K2 global form forced at config 4, {label}", 20,
                 lambda cols=cols, wcfg=wcfg: scan.dense_scan(
                     wcfg, cols, nrec, None, (), tb, form="global")))
    return out


def k12_runs(scan, dev) -> tuple:
    """K12's two-valued form at the mesh's compactions: config 3
    -loghist's (8 owners of 128 rows, 5 live) and path 2's (8 of 25,128,
    9,100 live), each owner's live rows first."""
    import torch
    out = ()
    for label, Sc, live, k in (("config 3 -loghist", 128, 5, 128),
                               ("path 2", 25_128, 9_100, 100_000)):
        fl = torch.zeros((8, Sc), dtype=torch.int32, device=dev)
        for d, n in enumerate(torch.arange(live).chunk(8)):
            fl[d, :n.numel()] = 1
        fl = fl.reshape(-1)
        out += ((f"K12 two-valued at {label}'s compaction ([{8 * Sc}], k "
                 f"{k})", 20,
                 lambda fl=fl, k=k: scan.topk_rows(fl, k, two_valued=True)),)
    return out


def k15_batch(scan, dev, shape: str, B: int = 128, D: int = 8):
    """A mesh batch's D shards, each scanned by scan_core as sharded_scan
    scans it, at config 3 -loghist's shape (status eq 200, group by host,
    a 166-bucket hist of ping: 128 table rows a shard, WP 174) or path 2's
    (config 4 at 300 s buckets on the sorted strategy over a time-sorted
    table, as chip_smoke's mesh spec: 100,000 table rows a shard, about
    9,070 live, WP 9), B blocks of 65,536 rows -> (config, parts, Sc)."""
    import torch

    from sybil_tpu_torch.parallel import mesh
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(15)
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    if shape == "config 3":
        cols = {"host": (torch.randint(0, 5, (B, C), device=dev,
                                       generator=g),
                         torch.rand((B, C), device=dev, generator=g) < 0.93),
                "ping": ((torch.randn((B, C), device=dev, generator=g) * 20
                          + 60).abs().to(torch.int64),
                         torch.rand((B, C), device=dev, generator=g) < 0.89),
                "status": (torch.randint(0, 5, (B, C), device=dev,
                                         generator=g), valid)}
        config = scan.ScanConfig(
            group_cols=("host",), aggs=(scan.AggSpec("ping", 0, 1, 166, 0,
                                                     165),),
            filters=(scan.FilterSpec("status", "eq", "str"),),
            key_bounds=((0, 5),), no_compact_table=True)
        fv, tb = torch.tensor([0], dtype=torch.int64, device=dev), 1
    else:
        now, month = 1_755_000_000, 4 * 7 * 86400
        t = torch.sort(now - torch.randint(0, month, (R,), device=dev,
                                           generator=g))[0]
        cols = {"time": (t.reshape(B, C), valid),
                "action": (torch.randint(0, 9, (B, C), device=dev,
                                         generator=g), valid),
                "weight": (torch.tensor([1, 10, 100], device=dev)[
                    torch.randint(0, 3, (B, C), device=dev, generator=g)],
                    valid)}
        config = scan.ScanConfig(
            group_cols=("action",), aggs=(scan.AggSpec("weight", 0, 0, 0, 1,
                                                       100),),
            filters=(), time_col="time", force_sorted=True, time_i32=True,
            agg_vbias=(1,), no_compact_table=True)
        fv, tb = None, 300
    Bs = B // D
    parts = [scan.scan_core(config, {k: (v[d * Bs:(d + 1) * Bs],
                                         m[d * Bs:(d + 1) * Bs])
                                     for k, (v, m) in cols.items()},
                            nrec[d * Bs:(d + 1) * Bs], fv, (), tb)
             for d in range(D)]
    return config, parts, mesh.shuffle_caps(config, D)[1]


def k15_call(config, parts, D: int, Sc: int):
    """K15 over the shards `parts` in the root's form: one call over all
    of them (shuffle_partition(config, parts, D, Sc, stats) -> send), or
    one call a shard into a [Dl, D, Sc, WP] send buffer."""
    import inspect

    import torch

    from sybil_tpu_torch.parallel import mesh
    dev = parts[0]["dev"]
    Dl = len(parts)
    stats = torch.zeros((Dl, mesh.n_stats(config)), dtype=torch.int64,
                        device=dev)
    if "parts" in inspect.signature(mesh.shuffle_partition).parameters:
        return lambda: mesh.shuffle_partition(config, parts, D, Sc, stats)
    WP = mesh.payload_spec(config)[-1]
    send = torch.empty((Dl, D, Sc, WP), dtype=torch.int64, device=dev)

    def per_shard():
        for d, part in enumerate(parts):
            mesh.shuffle_partition(config, part, D, Sc, send[d], stats[d])
    return per_shard


def k15_torch(config, parts, D: int):
    """The two torch calls that place the same shards' payload rows: a
    stable argsort of every shard's row owners keyed shard x (D + 1) +
    owner (D = dead), and an index_copy_ of the rows in that order; the
    payloads and owners prebuilt by the plain version."""
    import torch

    from sybil_tpu_torch.parallel import mesh
    K = config.n_key_cols
    pays, keys = [], []
    for d, part in enumerate(parts):
        payload, live = mesh.build_payload_plain(config, part)
        owner = torch.where(live, mesh.mix_keys_plain(payload[:, :K]) % D,
                            D)
        pays.append(payload)
        keys.append(owner + d * (D + 1))
    payload, key = torch.cat(pays), torch.cat(keys)
    buf = torch.zeros_like(payload)
    dst = torch.arange(payload.shape[0], device=payload.device)

    def lib():
        buf.index_copy_(0, dst, payload[torch.argsort(key, stable=True)])
    return lib


def k15_runs(scan, dev) -> tuple:
    """K15 over a whole mesh batch (8 shards) at config 3 -loghist's and
    path 2's shapes (k15_batch), beside the two torch calls over the same
    shards (k15_torch)."""
    out = ()
    for shape, what in (("config 3", "config 3 -loghist's 8 shards (128 "
                         "rows, WP 174)"),
                        ("path 2", "path 2's 8 shards (100,000 rows, WP "
                         "9)")):
        config, parts, Sc = k15_batch(scan, dev, shape)
        out += ((f"K15 at {what}", 50, k15_call(config, parts, 8, Sc)),
                (f"K15's torch calls at {what}", 20,
                 k15_torch(config, parts, 8)))
    return out


def prune_runs(scan, dev) -> tuple:
    """The sorted device prune at config 5's shape (group by userid, avg
    weight, -limit 100: K12 over the 100,000 slots' int64 $COUNT scores,
    k = P = 1,000, then the gather of the [100,000, 8] table's winners into
    main's prefix rows, W 9): K12 alone, the select and the gather as the
    root runs them (K12 then prune_gather, or prune_topk_gather's one
    call), and table[pidx]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    cfg = scan.ScanConfig(group_cols=("userid",),
                          aggs=(scan.AggSpec("weight", 0, 0, 0, 1, 100),),
                          filters=(), force_sorted=True, prune_topk=1000)
    S, P = cfg.max_groups, scan.table_prefix(cfg)
    Wt, W = scan.table_width(cfg), scan.main_width(cfg)
    score = torch.from_numpy(np.minimum(rng.zipf(1.3, S), 10 ** 6)
                             .astype(np.int64)).to(dev)
    table = torch.from_numpy(rng.integers(-10 ** 9, 10 ** 9, (S, Wt))).to(dev)
    main = torch.zeros((1 + P + 64, W), dtype=torch.int64, device=dev)
    if hasattr(scan, "prune_topk_gather"):
        def both():
            scan.prune_topk_gather(cfg, score, table, main)
    else:
        def both():
            scan.prune_gather(cfg, table, scan.topk_rows(score, P), main)
    pidx = scan.topk_rows(score, P).to(torch.int64)
    return ((f"prune: K12 alone at config 5 ([{S}] int64, k {P})", 50,
             lambda: scan.topk_rows(score, P)),
            (f"prune: the select and the gather at config 5 ({P} rows of "
             f"{Wt} words, W {W})", 50, both),
            ("prune: table[pidx] (torch)", 50, lambda: table[pidx]))


C5_ROWS = 4_194_304            # a config-5 partition's batch (64 blocks)


def c5_scores(dev):
    """Config 5's scores as K11 writes them for a partition's batch
    (bench_configs.py:64-98: userid = zipf(1.2) % 200,000 over 4,194,304
    rows, weight from {1, 10, 100}): in key order, the last row of each
    user's segment holds the user's row count (int64, $COUNT) or mean
    weight (f32, -prune-sort weight) and every other row -1 or -inf ->
    (int64 scores, f32 scores, live rows)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    uid = np.sort(rng.zipf(1.2, C5_ROWS) % 200_000)
    w = rng.choice([1, 10, 100], C5_ROWS).astype(np.int64)
    ends = np.flatnonzero(np.r_[uid[1:] != uid[:-1], True])
    starts = np.r_[0, ends[:-1] + 1]
    cnt = ends - starts + 1
    s64 = np.full(C5_ROWS, -1, np.int64)
    s64[ends] = cnt
    f32 = np.full(C5_ROWS, -np.inf, np.float32)
    f32[ends] = (np.add.reduceat(w, starts).astype(np.float32)
                 / cnt.astype(np.float32))
    return (torch.from_numpy(s64).to(dev), torch.from_numpy(f32).to(dev),
            len(ends))


def k12g_runs(scan, dev) -> tuple:
    """K12's general form at config 5's shapes, each beside torch.topk on
    the same scores: the enumerated strategy's select over a partition's
    4,194,304 K11 scores (int64 $COUNT, and f32 for -prune-sort weight),
    k 1,000; and the sorted device prune's over its 100,000 slots
    (prune_runs' scores), alone and with its gather (prune_topk_gather's
    one call)."""
    import numpy as np
    import torch
    s64, f32, live = c5_scores(dev)
    k = 1000
    rng = np.random.default_rng(5)
    cfg = scan.ScanConfig(group_cols=("userid",),
                          aggs=(scan.AggSpec("weight", 0, 0, 0, 1, 100),),
                          filters=(), force_sorted=True, prune_topk=1000)
    S, P = cfg.max_groups, scan.table_prefix(cfg)
    Wt, W = scan.table_width(cfg), scan.main_width(cfg)
    score = torch.from_numpy(np.minimum(rng.zipf(1.3, S), 10 ** 6)
                             .astype(np.int64)).to(dev)
    table = torch.from_numpy(rng.integers(-10 ** 9, 10 ** 9, (S, Wt))).to(dev)
    main = torch.zeros((1 + P + 64, W), dtype=torch.int64, device=dev)
    out = ()
    for what, sc in ((f"config 5 (int64 [{C5_ROWS}], {live} live, k {k})",
                      s64),
                     (f"config 5 -prune-sort weight (f32 [{C5_ROWS}], k {k})",
                      f32)):
        out += ((f"K12 general form at {what}", 20,
                 lambda sc=sc: scan.topk_rows(sc, k)),
                (f"K12's torch call torch.topk at {what}", 20,
                 lambda sc=sc: torch.topk(sc, k)))
    return out + (
        (f"K12 general form at the device prune ([{S}] int64, k {P})", 50,
         lambda: scan.topk_rows(score, P)),
        (f"K12 general form at the device prune with its gather ({P} rows "
         f"of {Wt} words, W {W})", 50,
         lambda: scan.prune_topk_gather(cfg, score, table, main)),
        (f"K12's torch call torch.topk at the device prune ([{S}] int64)", 50,
         lambda: torch.topk(score, P)))


def owner_batch(mesh, dev, shape: str, D: int = 8):
    """A mesh batch's received rows at -data-shards 8 on one process, as
    the exchange hands them to the owner loop: [8, D * Sc, WP] int64, each
    owner's D source blocks of Sc rows holding their live rows first (K15
    places them so).  Config 3 -loghist (Sc 128, WP 174): the 5 hosts'
    rows, one a source shard, at owners 0-4, owners 5-7 without a live
    row; path 2 (Sc 25,128, WP 9): every owner 9,108 live rows of 9,100
    keys.  The keys are the queries' own: config 3's host ids 0-4, path
    2's (action 0-8, a 300 s bucket of the four weeks) pairs -> (config,
    recv)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    sys.path.append(REPO)
    import chip_smoke
    o = dict(chip_smoke.K16_SHAPES["wide" if shape == "config 3" else
                                   "narrow"])
    o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o["aggs"])
    config = scan.ScanConfig(no_compact_table=True, **o)
    K, *_, WP = mesh.payload_spec(config)
    rng = np.random.default_rng(17)
    Sc = 128 if shape == "config 3" else 25_128
    recv = np.zeros((D, D, Sc, WP), np.int64)
    for d in range(D):
        nlive, ngroups = ((D, 1) if d < 5 else (0, 0)) \
            if shape == "config 3" else (9_108, 9_100)
        if not nlive:
            continue
        if shape == "config 3":
            keys = np.full((ngroups, K), d)
        else:
            pair = rng.choice(9 * 8064, ngroups, replace=False)
            keys = np.stack([pair // 8064,
                             1_752_580_800 + 300 * (pair % 8064)], axis=1)
        keys = keys[np.arange(nlive) % ngroups]
        for s, idx in enumerate(np.array_split(np.arange(nlive), D)):
            blk = recv[d, s, :len(idx)]
            blk[:] = rng.integers(0, 1000, blk.shape)
            blk[:, :K] = keys[idx]
            blk[:, K] = rng.integers(1, 100, len(idx))
    return config, torch.from_numpy(recv.reshape(D, D * Sc, WP)).to(dev)


def owner_loop(scan, mesh, config, recv):
    """A mesh batch's owner loop as the root runs it: one merge_owners
    call over every local owner, or shuffle_keys, sort_rows and
    shuffle_reduce an owner."""
    import torch
    Dl, N, WP = recv.shape
    Sc = N // 8
    dev = recv.device
    merged = torch.empty((Dl, Sc, WP), dtype=torch.int64, device=dev)
    flive = torch.empty((Dl, Sc), dtype=torch.int32, device=dev)
    stats = torch.zeros((Dl, mesh.n_stats(config)), dtype=torch.int64,
                        device=dev)
    if hasattr(mesh, "merge_owners"):
        return lambda: mesh.merge_owners(config, recv, merged, flive, stats)

    def per_owner():
        for d in range(Dl):
            keys, live_counts = mesh.shuffle_keys(config, recv[d])
            order = scan.sort_rows(config, {"key": None, "keys": keys})
            mesh.shuffle_reduce(config, recv[d], order, live_counts,
                                merged[d], flive[d], stats[d, 0:1])
    return per_owner


def owner_lanes(scan, mesh, config, recv):
    """The same owner loop with shuffle_keys' packed sort key refused
    (mesh._pack_plan answering None), so that sort_rows takes the K + 1
    lanes: the A/B of the two sort-key forms on one root's code."""
    loop = owner_loop(scan, mesh, config, recv)
    plan = mesh._pack_plan

    def lanes():
        mesh._pack_plan = lambda Dl, ranges: None
        try:
            loop()
        finally:
            mesh._pack_plan = plan
    return lanes


def owner_torch(scan, config, recv):
    """The owner loop's torch calls over the same batch: the masked
    transpose of every owner's keys (torch.where + contiguous, the live
    mask prebuilt) and the stable sorts by (owner, keys), the least
    significant first."""
    import torch
    K = config.n_key_cols
    Dl, N, WP = recv.shape
    flat = recv.reshape(Dl * N, WP)
    live = (flat[:, K] > 0) | (flat[:, K + 1] > 0)
    owner = torch.arange(Dl, device=recv.device).repeat_interleave(N)

    def lib():
        keys = torch.where(live[None, :], flat[:, :K].t(),
                           scan.SENTINEL).contiguous()
        p = torch.sort(keys[K - 1], stable=True)[1]
        for k in range(K - 2, -1, -1):
            p = p[torch.sort(keys[k][p], stable=True)[1]]
        return p[torch.sort(owner[p], stable=True)[1]]
    return lib


def owner_runs(scan, dev) -> tuple:
    """K16's owner loop over a whole mesh batch (8 owners) at config 3
    -loghist's and path 2's shapes (owner_batch), as the root runs it (on
    a root with the packed sort key, then with the K + 1 lanes and the
    packed key again, owner_lanes), beside its torch calls
    (owner_torch)."""
    from sybil_tpu_torch.parallel import mesh
    out = ()
    for shape, what in (("config 3", "config 3 -loghist (8 owners of 1,024 "
                         "rows, WP 174)"),
                        ("path 2", "path 2 (8 owners of 201,024 rows, WP "
                         "9)")):
        config, recv = owner_batch(mesh, dev, shape)
        out += ((f"K16 owner loop at {what}", 20,
                 owner_loop(scan, mesh, config, recv)),)
        if hasattr(mesh, "_pack_plan"):
            out += ((f"K16 owner loop, the K + 1 lanes sorted, at {what}", 20,
                     owner_lanes(scan, mesh, config, recv)),
                    (f"K16 owner loop, the packed key again, at {what}", 20,
                     owner_loop(scan, mesh, config, recv)))
        out += ((f"K16 owner loop's torch calls at {what}", 20,
                 owner_torch(scan, config, recv)),)
    return out


def c2_runs(scan, dev, B: int = 128) -> tuple:
    """K2 at config 2's shape (bench_configs.py:143-155: `action neq
    pageload, weight gt 5, group by action, page, hist weight`; 9 actions,
    8 pages, weights of 1, 10 and 100: 91 compact slots)."""
    import torch
    C = 65536
    g = torch.Generator(dev).manual_seed(2)
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    cols = {"action": (torch.randint(0, 9, (B, C), device=dev, generator=g),
                       valid),
            "page": (torch.randint(0, 8, (B, C), device=dev, generator=g),
                     valid),
            "weight": (torch.tensor([1, 10, 100], device=dev)[torch.randint(
                0, 3, (B, C), device=dev, generator=g)], valid)}
    cfg = scan.ScanConfig(
        group_cols=("action", "page"),
        aggs=(scan.AggSpec("weight", 1, 1, 100, 1, 100),),
        filters=(scan.FilterSpec("action", "neq", "str"),
                 scan.FilterSpec("weight", "gt", "int")),
        key_bounds=((0, 9), (0, 8)))
    fv = torch.tensor([0, 5], dtype=torch.int64, device=dev)
    return (("K2 config-2 shape", 20,
             lambda: scan.dense_scan(cfg, cols, nrec, fv)),)


def k1_runs(dev, B: int = 128) -> tuple:
    """K1 at row 1's shape (128 v2 blocks of 65,536 rows of config 1's
    `ping`, bench.py's abs(normal(60, 20)) at 89% valid, and of `host`, 5
    strings at 93%; 8 encoded blocks, each repeated 16 times) and at row
    10's (128 v1 edge blocks: chip_smoke's `bucket v1` block, 50 values
    at 90%); and the v2 `ping` launch with every row a missing block
    (src_of_row -1: only the zeroing runs)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.blocks import (IntColumnData, StrColumnData,
                                        encode_int_column, encode_str_column)
    from sybil_tpu_torch.ops import decode
    sys.path.insert(0, REPO)
    import chip_smoke
    C = 65536
    rng = np.random.default_rng(1)

    def mem(enc):
        return chip_smoke.MemContainer(*enc)

    ping = [mem(encode_int_column(IntColumnData(
        np.abs(rng.normal(60, 20, C)).astype(np.int64), rng.random(C) < 0.89)))
        for _ in range(8)]
    host = [mem(encode_str_column(StrColumnData(
        rng.integers(0, 5, C).astype(np.int32), rng.random(C) < 0.93,
        [f"h{i}" for i in range(5)]))) for _ in range(8)]
    idx = list(range(B))
    src = torch.arange(B, dtype=torch.int32, device=dev)
    zero = torch.full((B,), -1, dtype=torch.int32, device=dev)
    out = ()
    for label, cs in (("ping", ping), ("host", host)):
        ins = [torch.from_numpy(a).to(dev)
               for a in decode.bucket2_batch([cs[i % 8] for i in idx], idx)]
        out += ((f"K1 v2 at config 1's {label} ({B} blocks, "
                 f"{ins[0].dtype} deltas, K {ins[3].shape[1]})", 20,
                 lambda ins=ins: decode.decode_bucket2(*ins, src, C)),)
        if label == "ping":
            out += ((f"K1 v2 zeroing alone ({B} missing blocks)", 20,
                     lambda ins=ins: decode.decode_bucket2(*ins, zero, C)),)
    v1 = chip_smoke.v1_container(np.random.default_rng(11), C, 50, 0.9)
    ins = [torch.from_numpy(a).to(dev)
           for a in decode.bucket_v1_batch([v1] * B, idx)]
    out += ((f"K1 v1 edge blocks ({B}, {ins[0].dtype} deltas)", 20,
             lambda: decode.decode_bucket_v1(*ins, src, C)),)
    return out


# K6's value-mode delta types (decode._TORCH_CODE), each run at row 8's
# shape; int32 is config 4's time column's
K6_WIDTHS = ("uint8", "uint16", "int32", "int8", "int16", "int64")


def k6_runs(dev, B: int = 128) -> tuple:
    """K6 at row 9's shape: 128 blocks of 65,536 str ids (6,000 distinct,
    about half the rows valid) in its id mode, and the same rows as int32
    deltas in its value mode (config 4's time column is int32 deltas);
    then the value mode at each other delta type (random deltas over the
    type's range), and each width beside its torch call (an int64 cumsum
    plus the base, and the bit-unpack)."""
    import torch

    from sybil_tpu_torch.ops import decode
    C = 65536
    g = torch.Generator(dev).manual_seed(6)
    ids = torch.randint(0, 6000, (B, C), dtype=torch.int32, device=dev,
                        generator=g)
    bits = torch.randint(0, 256, (B, C // 8), dtype=torch.uint8,
                         device=dev, generator=g)
    bases = torch.randint(0, 1 << 40, (B,), device=dev, generator=g)
    src = torch.arange(B, dtype=torch.int32, device=dev)
    sh = torch.arange(8, dtype=torch.uint8, device=dev)

    def torch_call(d):
        return (torch.cumsum(d.to(torch.int64), 1) + bases[:, None],
                ((bits[:, :, None] >> sh) & 1).reshape(B, C) > 0)

    runs = [(f"K6 id mode, {B} blocks of {C} str ids", 20,
             lambda: decode.decode_ids(ids, bits, src, C))]
    for name in K6_WIDTHS:
        dt = getattr(torch, name)
        if dt is torch.int32:
            d = ids
        else:
            info = torch.iinfo(dt)
            d = torch.randint(max(info.min, -(1 << 62)),
                              min(info.max, 1 << 62), (B, C),
                              dtype=torch.int64, device=dev,
                              generator=g).to(dt)
        runs += [(f"K6 value mode, {B} blocks of {C} {name} deltas", 20,
                  lambda d=d: decode.decode_value(d, bits, bases, src, C)),
                 (f"K6's torch call cumsum + bit-unpack, {B} blocks of {C} "
                  f"{name} deltas", 20, lambda d=d: torch_call(d))]
    return tuple(runs)


def k11_runs(scan, dev) -> tuple:
    """K11 at config 5's shape (bench_configs.py:64-98: a partition's
    4,194,304 rows, userid = zipf(1.2) % 200,000, weight from {1, 10,
    100}, `group by userid, avg weight, limit 100`), after K7's enum form
    and the stable sort: its $COUNT score (int64) and -prune-sort
    weight's (the f32 mean), each beside its torch call (index_add_ of
    the L prebuilt lanes by segment into the zeroed [Smax, L] sums)."""
    import dataclasses

    import numpy as np
    import torch
    C = 65536
    B5 = C5_ROWS // C
    rng = np.random.default_rng(5)
    uid = rng.zipf(1.2, C5_ROWS) % 200_000
    w = rng.choice([1, 10, 100], C5_ROWS)
    valid = torch.ones((B5, C), dtype=torch.bool, device=dev)
    cols = {"userid": (torch.from_numpy(uid.astype(np.int64)).to(dev)
                       .reshape(B5, C), valid),
            "weight": (torch.from_numpy(w.astype(np.int64)).to(dev)
                       .reshape(B5, C), valid)}
    cfg = scan.ScanConfig(group_cols=("userid",),
                          aggs=(scan.AggSpec("weight", 0, 0, 0, 1, 100),),
                          filters=(), force_sorted=True, prune_topk=1000,
                          sort_pack=((0, 200_000),))
    cfgw = dataclasses.replace(cfg, prune_agg=0)
    nrec = torch.full((B5,), C, dtype=torch.int32, device=dev)
    front = scan.sorted_front(cfg, cols, nrec)
    skey, p = torch.sort(front["key"], stable=True)
    seg = scan.enum_segments(cfg, cols, skey, p)
    users = int(seg["num_groups"].item())
    smax = scan.enum_slots(cfg, C5_ROWS)
    L = 2 + 3 * len(cfg.aggs)
    g64 = seg["gid"].to(torch.int64)
    lanes = torch.ones((C5_ROWS, L), dtype=torch.int64, device=dev)
    what = f"config 5 ({C5_ROWS} rows, {users} users)"
    return (
        (f"K11 at {what}, $COUNT", 20,
         lambda: scan.enum_segments(cfg, cols, skey, p)),
        (f"K11 at {what}, -prune-sort weight (f32 score)", 20,
         lambda: scan.enum_segments(cfgw, cols, skey, p)),
        (f"K11's torch call index_add_ at {what}", 20,
         lambda: torch.zeros((smax, L), dtype=torch.int64,
                             device=dev).index_add_(0, g64, lanes)))


def k8_runs(scan, dev, B: int = 128) -> tuple:
    """K8 at the main path's shapes, each after its K7 and sorts: path 2
    (config 4 at 300 s buckets: time bucket and action as two unpacked
    int64 lanes, avg weight, about 72,576 groups; the rows time-sorted
    in 1,000,000-row runs as bulk ingests write them), path 1 (config
    3 -tdigest: status eq 200, an int32 packed host key, value-identity
    buckets of ping, so one min/max lane), the distinct pairs (group by
    host, distinct status, ping: K + D = 3 unpacked lanes) and the
    cache-group form (path 1's filter, unpacked, the cache-group key of
    8 groups of 16 blocks ahead of host)."""
    import dataclasses

    import torch
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(8)
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    now, month = 1_755_000_000, 4 * 7 * 86400
    t = now - torch.randint(0, month, (R,), device=dev, generator=g)
    for lo in range(0, R, 1_000_000):
        t[lo:lo + 1_000_000] = torch.sort(t[lo:lo + 1_000_000])[0]
    c4 = {"time": (t.reshape(B, C), valid),
          "action": (torch.randint(0, 9, (B, C), device=dev, generator=g),
                     valid),
          "weight": (torch.tensor([1, 10, 100], device=dev)[torch.randint(
              0, 3, (B, C), device=dev, generator=g)], valid)}
    p2 = scan.ScanConfig(
        group_cols=("action",), aggs=(scan.AggSpec("weight", 0, 0, 0, 1,
                                                   100),),
        filters=(), time_col="time", force_sorted=True, time_i32=True,
        agg_vbias=(1,))

    def col(v, p_valid):
        return v.reshape(B, C), (torch.rand((B, C), device=dev, generator=g)
                                 < p_valid)

    up = {"host": col(torch.randint(0, 5, (R,), device=dev, generator=g),
                      0.93),
          "ping": col((torch.randn(R, device=dev, generator=g) * 20 + 60)
                      .abs().to(torch.int64), 0.89),
          "status": col(torch.randint(0, 5, (R,), device=dev, generator=g),
                        1.0)}
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    status = (scan.FilterSpec("status", "eq", "str"),)
    p1 = scan.ScanConfig(
        group_cols=("host",), aggs=(scan.AggSpec("ping", 0, 1, 202, 0,
                                                 200),),
        filters=status, key_bounds=((0, 5),), force_sorted=True,
        sort_pack=((0, 5),))
    pairs = scan.ScanConfig(group_cols=("host",), aggs=(), filters=(),
                            distinct_cols=("status", "ping"),
                            force_sorted=True)
    cg = dataclasses.replace(p1, group_cols=("__cg__", "host"), sort_pack=(),
                             key_bounds=((0, B // 16), (0, 5)), vg_span=16)
    out = ()
    for label, cfg, cols, fv_, tb in (
            ("path 2 (two unpacked int64 lanes)", p2, c4, None, 300),
            ("path 1 (int32 packed key, a min/max lane)", p1, up, fv, 1),
            ("the distinct pairs (K + D = 3 lanes)", pairs, up, None, 1),
            ("the cache-group form (unpacked)", cg, up, fv, 1)):
        front = scan.sorted_front(cfg, cols, nrec, fv_, (), tb)
        order = scan.sort_rows(cfg, front)
        out += ((f"K8 at {label}", 20,
                 lambda cfg=cfg, cols=cols, front=front, order=order, tb=tb:
                 scan.segment_reduce(cfg, cols, front, order, tb)),)
    return out


def k7_runs(scan, dev, B: int = 128) -> tuple:
    """K7 at the main path's shapes, 8,388,608 rows unless noted: path 1
    (config 3 -tdigest: status eq 200, an int32 packed host key), path 2
    (config 4 at 300 s buckets: the time key and action, two int64
    lanes), the distinct lanes (group by host, distinct status, ping: K +
    D = 3), the cache-group lane (group_tdigest: 8 groups of 16 blocks
    ahead of host, unpacked), S3 (group by host, status, an int32 packed
    key, groups:in:mod5) and S4b (group by host, the matched mask) each
    beside the same launch without its set filter or mask, the enum form
    at config 5 (4,194,304 rows, group by userid, about 200,000 users)
    and one mesh shard of path 2 (1,048,576 rows)."""
    import dataclasses

    import numpy as np
    import torch
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(7)
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)

    def col(v, p_valid):
        return v.reshape(B, C), (torch.rand((B, C), device=dev, generator=g)
                                 < p_valid)

    up = {"host": col(torch.randint(0, 5, (R,), device=dev, generator=g),
                      0.93),
          "ping": col((torch.randn(R, device=dev, generator=g) * 20 + 60)
                      .abs().to(torch.int64), 0.89),
          "status": col(torch.randint(0, 5, (R,), device=dev, generator=g),
                        1.0)}
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    tdig = scan.AggSpec("ping", 0, 1, 202, 0, 200)
    status = (scan.FilterSpec("status", "eq", "str"),)
    p1 = scan.ScanConfig(group_cols=("host",), aggs=(tdig,), filters=status,
                         key_bounds=((0, 5),), force_sorted=True,
                         sort_pack=((0, 5),))
    now, month = 1_755_000_000, 4 * 7 * 86400
    t = now - torch.randint(0, month, (R,), device=dev, generator=g)
    for lo in range(0, R, 1_000_000):
        t[lo:lo + 1_000_000] = torch.sort(t[lo:lo + 1_000_000])[0]
    c4 = {"time": (t.reshape(B, C), valid),
          "action": (torch.randint(0, 9, (B, C), device=dev, generator=g),
                     valid),
          "weight": (torch.tensor([1, 10, 100], device=dev)[torch.randint(
              0, 3, (B, C), device=dev, generator=g)], valid)}
    p2 = scan.ScanConfig(
        group_cols=("action",), aggs=(scan.AggSpec("weight", 0, 0, 0, 1,
                                                   100),),
        filters=(), time_col="time", force_sorted=True, time_i32=True,
        agg_vbias=(1,))
    pairs = scan.ScanConfig(group_cols=("host",), aggs=(), filters=(),
                            distinct_cols=("status", "ping"),
                            force_sorted=True)
    cg = scan.ScanConfig(group_cols=("__cg__", "host"), aggs=(tdig,),
                         filters=(), key_bounds=((0, B // 16), (0, 5)),
                         force_sorted=True, vg_span=16)
    # S3 and S4b over the sets table's shape: `groups` holds mod2, mod3
    # and mod5 of a row's index (or none), K14's bitmasks prebuilt
    rng = np.random.default_rng(3)
    idx = np.arange(R)
    tags = [np.nonzero(idx % m == 0)[0] for m in (2, 3, 5)]
    rows = np.concatenate(tags).astype(np.int32)
    vals = np.concatenate([np.full(len(x), i) for i, x in enumerate(tags)])
    order = np.argsort(rows, kind="stable")
    from sybil_tpu_torch.query.engine import pad_set_csr
    prow, pval = pad_set_csr(rows[order], vals[order], R)
    csr = (torch.from_numpy(prow).to(dev), torch.from_numpy(pval).to(dev),
           len(rows))
    s3 = scan.ScanConfig(group_cols=("host", "status"), aggs=(tdig,),
                         filters=(scan.FilterSpec("groups", "in", "set"),),
                         force_sorted=True, sort_pack=((0, 5), (0, 5)))
    fv3 = torch.tensor([2], dtype=torch.int64, device=dev)
    sm3 = scan.set_filter_masks(s3, fv3, {"groups": csr}, R)
    s3_bare = dataclasses.replace(s3, filters=())
    s4 = scan.ScanConfig(group_cols=("host",), aggs=(tdig,), filters=(),
                         force_sorted=True, sort_pack=((0, 5),),
                         want_matched_mask=True)
    s4_bare = dataclasses.replace(s4, want_matched_mask=False)
    del rng
    # config 5: one partition's batch of 64 blocks, userid packed
    B5 = B // 2
    users = {"userid": (torch.randint(0, 200_000, (B5, C), device=dev,
                                      generator=g), valid[:B5]),
             "weight": (c4["weight"][0][:B5], valid[:B5])}
    c5 = scan.ScanConfig(group_cols=("userid",),
                         aggs=(scan.AggSpec("weight", 0, 0, 0, 1, 100),),
                         filters=(), force_sorted=True,
                         sort_pack=((0, 200_000),), prune_topk=1000)
    if scan.enum_radix(c5) <= 0:
        raise SystemExit("k7_runs: config 5's shape is not enumerable")
    Bs = B // 8
    shard = {k: (v[:Bs], m[:Bs]) for k, (v, m) in c4.items()}
    return (
        ("K7 path 1 (config 3 -tdigest: status eq 200, int32 packed host "
         "key)", 20, lambda: scan.sorted_front(p1, up, nrec, fv)),
        ("K7 path 2 (config 4 at 300 s buckets: time and action, two int64 "
         "lanes)", 20,
         lambda: scan.sorted_front(p2, c4, nrec, None, (), 300)),
        ("K7 the distinct lanes (host, distinct status, ping: K + D = 3)",
         20, lambda: scan.sorted_front(pairs, up, nrec)),
        ("K7 the cache-group lane (group_tdigest: 8 groups of 16 blocks, "
         "host)", 20, lambda: scan.sorted_front(cg, up, nrec)),
        ("K7 S3 with its set filter (host, status packed; groups:in:mod5)",
         20, lambda: scan.sorted_front(s3, up, nrec, fv3, set_masks=sm3)),
        ("K7 S3 without it (the same launch)", 20,
         lambda: scan.sorted_front(s3_bare, up, nrec)),
        ("K7 S4b with the matched mask (host packed)", 20,
         lambda: scan.sorted_front(s4, up, nrec)),
        ("K7 S4b without it (the same launch)", 20,
         lambda: scan.sorted_front(s4_bare, up, nrec)),
        (f"K7 enum form at config 5 ({B5 * C} rows, group by userid)", 20,
         lambda: scan.sorted_front(c5, users, nrec[:B5])),
        (f"K7 at one mesh shard ({Bs * C} rows, path 2's config)", 20,
         lambda: scan.sorted_front(p2, shard, nrec[:Bs], None, (), 300)))


# sort_permute run label -> its p, for the trace's sector counts
PERMUTES: dict = {}
# the --only prefixes that select pack_runs
PACK_PREFIXES = ("K3", "K10", "enum_pack", "dense_keyed")


def permute_runs(scan, dev, B: int = 128) -> tuple:
    """sort_permute at the main path's shapes, each beside its torch
    call: path 2's single step (8,388,608 rows, no base: the time lane
    gathered through the stable sort of action), the distinct pairs'
    second step (a base: the host lane through the sorts of ping and
    status) and path 2's mesh owner (201,024 rows of two lanes, 9,104
    live at the heads of the 8 sources' blocks, the rest SENTINEL); and
    path 2's gather with p the identity and with p a random permutation,
    which bracket what any gather of those bytes reaches on the card."""
    import torch
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(16)
    now, month = 1_755_000_000, 4 * 7 * 86400
    t = now - torch.randint(0, month, (R,), device=dev, generator=g)
    action = torch.randint(0, 9, (R,), device=dev, generator=g)
    p2 = torch.sort(action, stable=True)[1]
    host = torch.randint(0, 5, (R,), device=dev, generator=g)
    status = torch.randint(0, 5, (R,), device=dev, generator=g)
    ping = (torch.randn(R, device=dev, generator=g) * 20 + 60).abs().to(
        torch.int64)
    p0 = torch.sort(ping, stable=True)[1]
    base1, g1 = scan.sort_permute(None, p0, status)
    p1 = torch.sort(g1, stable=True)[1]
    D, Sc, live = 8, 25_128, 9_104
    N = D * Sc
    sent = torch.full((2, N), 2 ** 63 - 1, dtype=torch.int64, device=dev)
    for d, n in enumerate(torch.arange(live).chunk(D)):
        sent[0, d * Sc:d * Sc + n.numel()] = now - torch.randint(
            0, month, (n.numel(),), device=dev, generator=g)
        sent[1, d * Sc:d * Sc + n.numel()] = torch.randint(
            0, 9, (n.numel(),), device=dev, generator=g)
    po = torch.sort(sent[1], stable=True)[1]
    ident = torch.arange(R, device=dev)
    rand = torch.randperm(R, device=dev, generator=g)
    runs = (
        (f"sort_permute path 2, no base ({R} rows)", p2,
         lambda: scan.sort_permute(None, p2, t)),
        ("sort_permute path 2's torch call keys[p]", None, lambda: t[p2]),
        ("sort_permute the distinct pairs' second step, with a base", p1,
         lambda: scan.sort_permute(base1, p1, host)),
        ("sort_permute that step's torch calls base[p], nxt[perm]", None,
         lambda: host[base1[p1]]),
        (f"sort_permute path 2's owner ({N} rows, two lanes)", po,
         lambda: scan.sort_permute(None, po, sent[0])),
        ("sort_permute the owner's torch call keys[p]", None,
         lambda: sent[0][po]),
        ("sort_permute gather reference: path 2 with p the identity", ident,
         lambda: scan.sort_permute(None, ident, t)),
        ("sort_permute gather reference: path 2 with p a random "
         "permutation", rand, lambda: scan.sort_permute(None, rand, t)))
    PERMUTES.update({label: p for label, p, _ in runs if p is not None})
    return tuple((label, 20, fn) for label, _, fn in runs)


def pack_runs(scan, dev, B: int = 128) -> tuple:
    """K3 and K10, both entries each, at the main path's shapes
    (8,388,608 rows unless noted; `main` allocated once a run, as
    pack_parts allocates it once a batch): K3 at config 1 (group by host,
    avg ping: 7 compact slots), config 3 (status eq 200, hist ping: its
    gid and bucket sections), the device HLL's 8 planes (group by host,
    distinct ping: K13's registers) and a mesh's merged keyed table
    (config 3 -loghist at -data-shards 8: 128 rows, outliers tracked);
    dense_keyed at a -read-log pseudo-block (config 1, 65,536 rows, 128
    slots, Sc 9); K10 at path 1 (config 3 -tdigest: an int32 packed key
    and value-identity buckets of ping, its 8,192-row pair section, about
    750 pairs), path 2 (config 4 at 300 s buckets: two unpacked int64
    lanes), the distinct pairs (group by host, distinct status, ping: a
    16,384-row pair section), the device prune (config 5's 100,000 slots,
    $COUNT scores and totals) and a mesh batch's merged table (path 2's,
    every aggregation's min and max, the overflow word); enum_pack at
    config 5 (a partition's 4,194,304 sorted packed keys, 1,000
    winners)."""
    import dataclasses

    import torch
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(18)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)

    def col(v, p_valid, b=B):
        return (v.reshape(b, -1),
                torch.rand(v.numel(), device=dev, generator=g).reshape(b, -1)
                < p_valid)

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), device=dev, generator=g)

    def main_of(cfg, rows=R):
        lay = scan.packed_layout(cfg, rows)
        return torch.zeros((lay["rows"], lay["W"]), dtype=torch.int64,
                           device=dev)

    ping = (torch.randn(R, device=dev, generator=g) * 20 + 60).abs().to(
        torch.int64)
    up = {"host": col(rint(0, 5, R), 0.93), "ping": col(ping, 0.89),
          "status": col(rint(0, 5, R), 1.0)}
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    status = (scan.FilterSpec("status", "eq", "str"),)
    avg = scan.AggSpec("ping", 0, 0, 0, 0, 200)
    hist = scan.AggSpec("ping", 0, 1, 166, 0, 165)
    c1 = scan.ScanConfig(group_cols=("host",), aggs=(avg,), filters=(),
                         key_bounds=((0, 5),))
    c3 = scan.ScanConfig(group_cols=("host",), aggs=(hist,), filters=status,
                         key_bounds=((0, 5),))
    chll = scan.ScanConfig(group_cols=("host",), aggs=(), filters=(),
                           distinct_cols=("ping",), key_bounds=((0, 5),),
                           hll=True)
    runs = []
    k2 = scan.dense_scan(c1, up, nrec)
    runs.append(("K3 at config 1 (compact table)", c1, k2, [], [], None,
                 main_of(c1), R))
    k2 = scan.dense_scan(c3, up, nrec, fv)
    h = scan.dense_hist(c3, 0, up, k2["gid"])
    runs.append(("K3 at config 3 with its hist sections (Ph 128)", c3, k2,
                 [h["hist"]], [h["nout"]], None, main_of(c3), R))
    k2 = scan.dense_scan(chll, up, nrec)
    regs = scan.hll_registers(chll, up, k2["gid"])
    runs.append(("K3 with the device HLL's 8 planes", chll, k2, [], [],
                 regs, main_of(chll), R))
    # a mesh's merged keyed table at config 3 -loghist: every slot a row
    cm = dataclasses.replace(c3, track_outliers=True, no_compact_table=True)
    slots, A, nv = cm.dense_slots, 1, hist.num_values
    merged = {"keys": rint(-1, 5, slots).reshape(slots, 1),
              "sums": rint(0, 1000, (slots + 1) * (2 + 3 * A)).reshape(
                  slots + 1, 2 + 3 * A),
              "mins": rint(0, 50, slots * A).reshape(slots, A),
              "maxs": rint(50, 166, slots * A).reshape(slots, A),
              "spill": torch.zeros(1, dtype=torch.int64, device=dev),
              "num_groups": torch.tensor([5], dtype=torch.int64, device=dev),
              "overflow": torch.zeros(1, dtype=torch.int64, device=dev)}
    mh = rint(0, 1000, slots * nv).reshape(slots, nv)
    mn = torch.zeros(1, dtype=torch.int64, device=dev)
    runs.append((f"K3 merged keyed form (config 3 -loghist at 8 shards, "
                 f"{slots} rows)", cm, merged, [mh], [mn], None, main_of(cm),
                 R))
    # a -read-log pseudo-block: one [1, 65536] batch, 8 hosts
    ck = dataclasses.replace(c1, key_bounds=((0, 7),), no_compact_table=True)
    pb = {"host": col(rint(0, 8, C), 0.93, 1), "ping": col(ping[:C], 0.89, 1)}
    k2 = scan.dense_scan(ck, pb, nrec[:1])
    runs.append((f"dense_keyed at a -read-log pseudo-block ({C} rows, "
                 f"{ck.dense_slots} slots, Sc {scan.reduce_space(ck)[1]})",
                 ck, k2, [], [], None, main_of(ck, C), C))
    out = tuple(
        (label, 200, lambda cfg=cfg, k2=k2, hs=hs, ns=ns, hll=hll, m=m, r=r:
         scan.dense_pack(cfg, k2, hs, ns, m, r, hll))
        for label, cfg, k2, hs, ns, hll, m, r in runs)

    # K10: the sorted strategy's parts, as scan_core hands them to the pack
    now, month = 1_755_000_000, 4 * 7 * 86400
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    tcol = now - rint(0, month, R)
    for lo in range(0, R, 1_000_000):
        tcol[lo:lo + 1_000_000] = torch.sort(tcol[lo:lo + 1_000_000])[0]
    c4 = {"time": (tcol.reshape(B, C), valid),
          "action": (rint(0, 9, R).reshape(B, C), valid),
          "weight": (torch.tensor([1, 10, 100], device=dev)[rint(0, 3, R)]
                     .reshape(B, C), valid)}
    p1 = scan.ScanConfig(
        group_cols=("host",), aggs=(scan.AggSpec("ping", 0, 1, 202, 0,
                                                 200),),
        filters=status, key_bounds=((0, 5),), force_sorted=True,
        sort_pack=((0, 5),))
    p2 = scan.ScanConfig(
        group_cols=("action",), aggs=(scan.AggSpec("weight", 0, 0, 0, 1,
                                                   100),),
        filters=(), time_col="time", force_sorted=True, time_i32=True,
        agg_vbias=(1,))
    pairs = scan.ScanConfig(group_cols=("host",), aggs=(), filters=(),
                            distinct_cols=("status", "ping"),
                            force_sorted=True)
    runs = []
    for label, cfg, cols, fv_, tb in (
            ("path 1 (config 3 -tdigest, its pair section)", p1, up, fv, 1),
            ("path 2 (two unpacked int64 lanes)", p2, c4, None, 300),
            ("the distinct pairs (16,384-row section)", pairs, up, None, 1)):
        parts = scan.scan_core(cfg, cols, nrec, fv_, (), tb)
        npairs = [int(hp["npairs"].item()) for hp in parts["pairs"]]
        runs.append((f"K10 at {label}"
                     + (f", {npairs[0]} pairs" if npairs else ""), cfg,
                     parts["k8"], parts["spill"], parts["pairs"],
                     parts["nouts"], main_of(cfg), None))
    # the device prune at config 5: 100,000 slots' sums, 7,000 live
    cp = scan.ScanConfig(group_cols=("userid",),
                         aggs=(scan.AggSpec("weight", 0, 0, 0, 1, 100),),
                         filters=(), force_sorted=True, prune_topk=1000)
    S, L = cp.max_groups, 5
    sums = torch.zeros((S + 1, L), dtype=torch.int64, device=dev)
    sums[:7000] = rint(1, 5000, 7000 * L).reshape(7000, L)
    k8p = {"keys": rint(0, 200_000, S).reshape(S, 1), "sums": sums,
           "mins": torch.zeros((S, 0), dtype=torch.int64, device=dev),
           "maxs": torch.zeros((S, 0), dtype=torch.int64, device=dev),
           "num_groups": torch.tensor([7000], dtype=torch.int64, device=dev)}
    spill = torch.zeros(1, dtype=torch.int64, device=dev)
    runs.append((f"K10 prune form at config 5 ({S} slots: score and "
                 f"totals)", cp, k8p, spill, [], [], main_of(cp, C5_ROWS),
                 None))
    # a mesh batch's merged table at path 2 (every aggregation's min/max)
    k8m = {"keys": rint(0, 10 ** 6, S * 2).reshape(S, 2),
           "sums": rint(0, 1000, (S + 1) * L).reshape(S + 1, L),
           "mins": rint(1, 50, S).reshape(S, 1),
           "maxs": rint(50, 100, S).reshape(S, 1),
           "num_groups": torch.tensor([72_585], dtype=torch.int64,
                                      device=dev)}
    runs.append((f"K10 merged form (path 2's mesh batch, {S} rows)", p2, k8m,
                 spill, [], [], main_of(p2),
                 torch.zeros(1, dtype=torch.int64, device=dev)))
    out += tuple(
        (label, 50, lambda cfg=cfg, k8=k8, sp=sp, hp=hp, ns=ns, m=m, ov=ov:
         scan.sorted_pack(cfg, k8, sp, hp, ns, m,
                          C5_ROWS if cfg.prune_topk else R, overflow=ov))
        for label, cfg, k8, sp, hp, ns, m, ov in runs)

    # enum_pack at config 5: K11's segments of sorted zipf user ids
    ce = dataclasses.replace(cp, sort_pack=((0, 200_000),))
    Re = C5_ROWS
    skey = torch.sort((torch.rand(Re, device=dev, generator=g) ** 4
                       * 200_000).to(torch.int32))[0]
    starts = torch.ones(Re, dtype=torch.bool, device=dev)
    starts[1:] = skey[1:] != skey[:-1]
    gid = (torch.cumsum(starts.to(torch.int32), 0) - 1).to(torch.int32)
    Smax = scan.enum_slots(ce, Re)
    seg = {"gid": gid,
           "sums": rint(0, 5000, Smax * L).reshape(Smax, L),
           "num_groups": starts.sum().reshape(1)}
    ends = torch.nonzero(torch.cat([starts[1:], starts[:1]])).reshape(-1)
    widx = ends[torch.randperm(ends.numel(), device=dev,
                               generator=g)[:1000]].to(torch.int32)
    totals = torch.tensor([Re, Re], dtype=torch.int64, device=dev)
    me = main_of(ce, Re)
    return out + ((f"enum_pack at config 5 ({Re} rows, "
                   f"{int(seg['num_groups'].item())} users, 1000 winners)",
                   50, lambda: scan.enum_pack(ce, skey, seg, widx, spill,
                                              totals, me)),)


def b5_runs(scan, dev, B: int = 128) -> tuple:
    """Three of the wrappers that bind their C entry once (kernels.entry)
    at the main path's shapes: K9's hist_prep, the stable sort of its
    pair key and hist_pairs at path 1 (config 3 -tdigest, 8,388,608 rows)
    and K11 enum_segments at config 5 (a partition's 4,194,304 rows, zipf
    user ids); and K5 over path 1's kmat with outliers tracked.  (K4 and
    K13: the K4 and K13 runs; K14 set_match and K5 at config 3's shape:
    the K14 and K5 runs.)"""
    import dataclasses

    import torch
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(19)
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)

    def col(v, p_valid, b=B):
        return (v.reshape(b, -1),
                torch.rand(v.numel(), device=dev, generator=g).reshape(b, -1)
                < p_valid)

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), device=dev, generator=g)

    ping = (torch.randn(R, device=dev, generator=g) * 20 + 60).abs().to(
        torch.int64)
    up = {"host": col(rint(0, 5, R), 0.93), "ping": col(ping, 0.89),
          "status": col(rint(0, 5, R), 1.0)}
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    status = (scan.FilterSpec("status", "eq", "str"),)
    p1 = scan.ScanConfig(
        group_cols=("host",), aggs=(scan.AggSpec("ping", 0, 1, 202, 0,
                                                 200),),
        filters=status, key_bounds=((0, 5),), force_sorted=True,
        sort_pack=((0, 5),))
    front = scan.sorted_front(p1, up, nrec, fv)
    k8 = scan.segment_reduce(p1, up, front, scan.sort_rows(p1, front))
    prep = scan.hist_prep(p1, 0, up, k8)
    pk = prep["pairkey"]
    spk, si2 = torch.sort(pk, stable=True)
    # K5 over path 1's sorted keys with outliers tracked: ping's hist ends
    # at the discard bound, so no row is live, as on the bench table
    p1t = dataclasses.replace(p1, track_outliers=True)
    front_t = scan.sorted_front(p1t, up, nrec, fv)
    k8t = scan.segment_reduce(p1t, up, front_t, scan.sort_rows(p1t, front_t))
    prep_t = scan.hist_prep(p1t, 0, up, k8t)
    lay_t = scan.packed_layout(p1t, R)
    main_t = torch.zeros((lay_t["rows"], lay_t["W"]), dtype=torch.int64,
                         device=dev)
    off_t = lay_t["out0"][0]
    n_t = int(prep_t["nout"].item())
    # config 5: a partition's batch of 64 blocks
    B5 = C5_ROWS // C
    ce = scan.ScanConfig(group_cols=("userid",),
                         aggs=(scan.AggSpec("weight", 0, 0, 0, 1, 100),),
                         filters=(), force_sorted=True, prune_topk=1000,
                         sort_pack=((0, 200_000),))
    uid = (torch.rand(C5_ROWS, device=dev, generator=g) ** 4
           * 200_000).to(torch.int64)
    valid = torch.ones((B5, C), dtype=torch.bool, device=dev)
    cols5 = {"userid": (uid.reshape(B5, C), valid),
             "weight": (torch.tensor([1, 10, 100], device=dev)[
                 rint(0, 3, C5_ROWS)].reshape(B5, C), valid)}
    front5 = scan.sorted_front(ce, cols5, nrec[:B5])
    skey, p = torch.sort(front5["key"], stable=True)
    return (
        ("B5 hist_prep at path 1", 20,
         lambda: scan.hist_prep(p1, 0, up, k8)),
        (f"B5 pair-key sort at path 1 ({str(pk.dtype)[6:]})", 20,
         lambda: torch.sort(pk, stable=True)),
        ("B5 hist_pairs at path 1", 20,
         lambda: scan.hist_pairs(p1, 0, spk, si2, prep["w"], k8["kmat"])),
        (f"K5 path 1 over kmat ({n_t} live rows)", 50,
         lambda: scan.outlier_compact(p1t, up, prep_t["out_mask"],
                                      prep_t["out_val"], main_t, off_t,
                                      kmat=k8t["kmat"])),
        (f"B5 enum_segments at config 5 ({C5_ROWS} rows)", 20,
         lambda: scan.enum_segments(ce, cols5, skey, p)))


def _k4_form(scan, cfg, dev, R: int) -> str:
    """K4's table and grid at a config, as the root picks them: Sc, nv,
    the table and the CTAs."""
    _, Sc, _ = scan.reduce_space(cfg)
    nv = cfg.aggs[0].num_values
    form = scan.dense_hist_path(cfg, 0)
    grid = (scan.tile_grid(dev, R) if hasattr(scan, "tile_grid") else
            scan._grid(dev, R, Sc * nv * 8, form == "shared"))
    return f"Sc {Sc}, nv {nv}, {form}, grid {grid}"


def _k13_form(scan, cfg, dev, R: int) -> str:
    """K13's planes and grid at a config, as the root picks them."""
    slots, Sc, _ = scan.reduce_space(cfg)
    if hasattr(scan, "hll_route"):
        form, grid = scan.hll_route(cfg), scan.tile_grid(dev, R)
    else:
        form, grid = "global", scan._grid(dev, R, 0, False)
    return f"slots {slots}, Sc {Sc}, {form}, grid {grid}"


def hist_hll_runs(scan, dev, B: int = 128) -> tuple:
    """K4 and K13 at the main path's shapes, 8,388,608 rows (k2_ab's
    uptime columns: 5 hosts at 93%, ping abs(normal(60, 20)) at 89%, 5
    statuses): K4 at config 3 (`status eq 200, group by host, hist ping`:
    Sc 7, nv 166), config 3 -loghist (one multihist sub-range, outliers
    tracked), config 2 (`action neq pageload, weight gt 5, group by
    action, page, hist weight`: Sc 91, nv 101) and chip_smoke.py's
    global-table edge batch, after K2's gid; K13 at
    `group by host` (Sc 7 planes) with the int hash (index_int: a distinct
    value a row) and the str hash (status: 5 ids, a 6-entry hash array),
    and both again at 126 groups (128 slots, the bind's cap, none compact:
Sc 128 planes).  Each
    label names the table, the route and the grid the root takes."""
    import torch
    C = 65536
    R = B * C
    g = torch.Generator(dev).manual_seed(4)

    def rint(lo, hi, shape=(B, C)):
        return torch.randint(lo, hi, shape, device=dev, generator=g)

    def valid(p):
        return torch.rand((B, C), device=dev, generator=g) < p

    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    ping = (torch.randn((B, C), device=dev, generator=g) * 20 + 60).abs().to(
        torch.int64)
    up = {"host": (rint(0, 5), valid(0.93)), "ping": (ping, valid(0.89)),
          "status": (rint(0, 5), torch.ones((B, C), dtype=torch.bool,
                                            device=dev))}
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    status = (scan.FilterSpec("status", "eq", "str"),)
    c3 = scan.ScanConfig(group_cols=("host",),
                         aggs=(scan.AggSpec("ping", 0, 1, 166, 0, 1640),),
                         filters=status, key_bounds=((0, 5),))
    c3l = scan.ScanConfig(
        group_cols=("host",),
        aggs=(scan.AggSpec("ping", 0, 0, 166, 0, 1640,
                           sub_edges=((0, 164, 1, 166, 0),)),),
        filters=status, key_bounds=((0, 5),), track_outliers=True)
    ones = torch.ones((B, C), dtype=torch.bool, device=dev)
    c2cols = {"action": (rint(0, 9), ones), "page": (rint(0, 8), ones),
              "weight": (torch.tensor([1, 10, 100], device=dev)[rint(0, 3)],
                         ones)}
    c2 = scan.ScanConfig(
        group_cols=("action", "page"),
        aggs=(scan.AggSpec("weight", 1, 1, 101, 1, 1000),),
        filters=(scan.FilterSpec("action", "neq", "str"),
                 scan.FilterSpec("weight", "gt", "int")),
        key_bounds=((0, 9), (0, 8)))
    c2fv = torch.tensor([0, 5], dtype=torch.int64, device=dev)
    # chip_smoke.py's edge batch whose hist table is past the shared
    # budget (3 x 65,536 rows, Sc 8,191, nv 12, weighted)
    sys.path.append(REPO)
    import chip_smoke
    edge = chip_smoke.edge_scan("hist table in global memory", dev)
    runs = []
    for label, cfg, cols, f, n in (
            ("config 3", c3, up, fv, nrec),
            ("config 3 -loghist", c3l, up, fv, nrec),
            ("config 2", c2, c2cols, c2fv, nrec),
            ("global-table edge batch", edge[0], edge[1], edge[3], edge[2])):
        gid = scan.dense_scan(cfg, cols, n, f)["gid"]
        rows = n.numel() * C
        runs.append((f"K4 {label} ({_k4_form(scan, cfg, dev, rows)})", 20,
                     lambda cfg=cfg, cols=cols, gid=gid:
                     scan.dense_hist(cfg, 0, cols, gid)))
    hll = dict(up, index_int=(torch.arange(R, device=dev).reshape(B, C),
                              ones),
               many=(rint(0, 126), valid(0.97)))
    hashes = (torch.randint(-2 ** 63, 2 ** 63 - 1, (6,), device=dev,
                            generator=g),)
    for keys, bounds in ((("host",), ((0, 5),)), (("many",), ((0, 126),))):
        for tag, col, idx in (("int", "index_int", -1),
                              ("str", "status", 0)):
            cfg = scan.ScanConfig(group_cols=keys, aggs=(), filters=(),
                                  distinct_cols=(col,), key_bounds=bounds,
                                  hll=True, hll_hash_idx=idx)
            sub = {k: hll[k] for k in keys + (col,)}
            gid = scan.dense_scan(cfg, sub, nrec)["gid"]
            bits = hashes if idx >= 0 else ()
            runs.append((f"K13 {tag} hash, distinct {col} "
                         f"({_k13_form(scan, cfg, dev, R)})", 20,
                         lambda cfg=cfg, sub=sub, gid=gid, bits=bits:
                         scan.hll_registers(cfg, sub, gid, bits)))
    return tuple(runs)


def atomics(root: str, kernels, names) -> list:
    """The atomic instructions each kernel of the root's libraries
    `names` compiled to (cuobjdump -sass), one line a kernel over its
    template instances, and ptxas's registers of each instance."""
    import collections
    import re
    out = []
    paths = kernels.build(names)
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    for name, so in paths.items():
        sass = subprocess.run([tool, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        fn, ops = None, collections.defaultdict(collections.Counter)
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?(ATOM\S*|RED(?!UX)\S*)",
                          line)
            if fn and m:
                ops[fn][m.group(1)] += 1
        # one line a kernel and atomics mix, over its template instances
        seen = collections.Counter()
        for fn, c in ops.items():
            # the mangled name past its anonymous namespace, without its
            # template arguments
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "", fn)
            short = re.split(r"I[LE]|E", short)[0]
            seen[(short, tuple(sorted(c.items())))] += 1
        for (short, c), n in seen.items():
            out.append(f"{root}: {name} {short} ({n} instances): {dict(c)}")
        log = os.path.join(os.path.dirname(so), name + ".log")
        if os.path.exists(log):
            regs = collections.Counter()
            fn = None
            for line in open(log, errors="replace"):
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+", "",
                                m.group(1))
                    fn = re.split(r"I[LE]|E", fn)[0]
                m = re.search(r"Used (\d+) registers", line)
                if m and fn:
                    regs[(fn, int(m.group(1)))] += 1
            out.append(f"{root}: {name} registers (kernel, registers: "
                       f"instances): "
                       + ", ".join(f"{f} {r}: {n}"
                                   for (f, r), n in sorted(regs.items())))
    return out


def trace(root: str) -> str:
    """The root's K2 and K12 libraries' atomics by kernel, and config
    4's chunk spans."""
    import torch
    kernels, scan = _import_root(root)
    out = atomics(root, kernels, ("dense_scan", "topk_rows"))
    dev = torch.device("cuda")
    for what, _, fn in c4_runs(scan, dev):
        if "windowed" not in what:
            continue
        cols = fn.__defaults__[0]          # the layout's columns
        t, a = cols["time"][0].reshape(-1), cols["action"][0].reshape(-1)
        gid = (torch.div(t, 3600, rounding_mode="floor") * 10 + a).reshape(
            -1, 8192)
        span = (gid.max(1)[0] - gid.min(1)[0] + 1).float()
        distinct = torch.tensor([torch.unique(gid[i]).numel()
                                 for i in range(0, gid.shape[0], 64)])
        out.append(f"{what}: 8,192-row chunks' live span median "
                   f"{span.median().item():.0f} slots, max "
                   f"{span.max().item():.0f}, {(span > 4096).sum().item()} "
                   f"of {gid.shape[0]} wider than 4,096; distinct gids a "
                   f"chunk (every 64th) median "
                   f"{distinct.float().median().item():.0f}")
    sys.path.insert(0, REPO)
    import chip_smoke
    for what, n, fn in k6_runs(dev) + k8_runs(scan, dev):
        out.append(f"{root}: {what}: {_ms(fn, n):.4f} ms wall, "
                   f"{_ms(fn, n, queued=True):.4f} ms device; "
                   f"{chip_smoke.profiled_kernels(fn)}")
        if not what.startswith("K8"):
            continue
        # the sorted rows' gathers: how often a row's source row shares
        # its predecessor's 32-byte sector (int32 and int64 columns), and
        # the segments a 4,096-row tile holds or cuts
        _, _, front, order, _ = fn.__defaults__
        perm = scan.sorted_perm(order)
        k8 = fn()
        gid = k8["gid"].to(torch.int64)
        R = gid.numel()
        edges = torch.arange(4096, R, 4096, device=gid.device)
        cut = (gid[edges] == gid[edges - 1]).sum().item()
        out.append(
            f"{root}: {what}: {int(k8['num_groups'].item())} groups; "
            f"source row in its predecessor's sector: int32 "
            f"{(perm[1:] // 8 == perm[:-1] // 8).float().mean().item():.3f}"
            f", int64 "
            f"{(perm[1:] // 4 == perm[:-1] // 4).float().mean().item():.3f};"
            f" {cut} of {edges.numel()} tile edges cut a segment")
    return "\n".join(out)


def trace_runs(root: str, only) -> str:
    """Each run selected by `only`: its wall and device times and its
    device work a call as torch.profiler records it."""
    runs = kernel_runs(root, only)
    sys.path.insert(0, REPO)
    import chip_smoke
    out = []
    from sybil_tpu_torch.ops import kernels
    if any(o in ("K1", "K2") for o in only):
        out += atomics(root, kernels, ("decode_bucket2", "dense_scan"))
    if any(o.startswith(("K7", "sort_permute")) for o in only):
        out += atomics(root, kernels, ("sorted_front",))
    if any(o in ("K4", "K13") for o in only):
        out += atomics(root, kernels, ("dense_hist", "hll_registers"))
    if any(o in ("K6", "K11") for o in only):
        out += atomics(root, kernels, ("decode_value", "enum_segments"))
    if any(o in ("B5", "K5") for o in only):
        out += atomics(root, kernels, ("hist_pairs", "outlier_compact"))
    for what, n, fn in runs:
        line = (f"{root}: {what}: {_ms(fn, n):.4f} ms wall, "
                f"{_ms(fn, n, queued=True):.4f} ms device, "
                f"{_host_us(fn):.1f} us host; "
                f"{chip_smoke.profiled_kernels(fn)}")
        p = PERMUTES.get(what)
        if p is not None:
            # how often row i's source shares row i-1's 32-byte sector
            # of an int64 lane, and the ascending runs p walks
            same = (p[1:] // 4 == p[:-1] // 4).float().mean().item()
            line += (f"; source row in its predecessor's sector {same:.3f}"
                     f", runs of ascending p "
                     f"{int((p[1:] < p[:-1]).sum().item()) + 1}")
        out.append(line)
    return "\n".join(out)


def build_walls_table(table_dir: str) -> None:
    """chip_smoke.py's uptime table under table_dir, and its time-sorted
    user_sessions table under table_dir/sessions (path 2's), unless they
    are there."""
    sys.path.insert(0, REPO)
    import chip_smoke
    if not os.path.isdir(os.path.join(table_dir, "uptime")):
        t0 = time.perf_counter()
        chip_smoke.build_table(table_dir, ROWS)
        print(f"built the uptime table ({ROWS} rows) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    sessions = os.path.join(table_dir, "sessions")
    if not os.path.isdir(os.path.join(sessions, "user_sessions")):
        t0 = time.perf_counter()
        chip_smoke.build_sessions(os.path.join(table_dir, "sessions_bulk"),
                                  sessions, ROWS)
        print(f"built the user_sessions tables ({ROWS} rows) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def time_walls(root: str, table_dir: str, n: int = 15) -> str:
    import dataclasses

    import numpy as np
    import torch

    _import_root(root)
    from sybil_tpu_torch import profiler
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.query.engine import run_query
    from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
    from sybil_tpu_torch.table import Table

    # each query's phase totals, as its PhaseTimer reports them
    seen = []
    report = profiler.PhaseTimer.report

    def keep(self, label="query"):
        seen.append(dict(self.totals))
        return report(self, label)

    profiler.PhaseTimer.report = keep
    flags = Flags(dir=table_dir, table="uptime", skip_compact=True,
                  device="cuda", device_batch=1024)
    table = Table("uptime", flags)
    table.load_info()
    queries = {
        "config 1": QueryParams(groups=("host",),
                                aggs=(AggDef("ping", "avg", "basic"),)),
        "config 3": QueryParams(
            groups=("host",), aggs=(AggDef("ping", "hist", "basic"),),
            filters=(FilterDef("status", "eq", "200", "str"),)),
    }
    runs = [(label, table, params, dataclasses.replace(flags))
            for label, params in queries.items()]
    # path 2 (config 4 at 300 s buckets, the sorted strategy) on the
    # time-sorted user_sessions table, one batch, as chip_smoke's mesh
    # phase runs it
    sys.path.insert(0, REPO)
    import chip_smoke
    stable = Table("user_sessions", Flags(
        dir=os.path.join(table_dir, "sessions"), table="user_sessions",
        skip_compact=True, device="cuda", device_batch=1024))
    stable.load_info()
    sflags, sparams = chip_smoke.cli_query(
        stable, chip_smoke.P2_ARGV + ["-device-batch",
                                      str(len(stable.block_infos()))])
    runs.append(("path 2", stable, sparams, sflags))
    if hasattr(flags, "data_shards"):   # the root has the mesh scan
        runs += [(f"{label} -data-shards 8", t, params,
                  dataclasses.replace(f, data_shards=8))
                 for label, t, params, f in list(runs)]
    out = []
    for label, qtable, params, qflags in runs:
        for _ in range(3):
            run_query(qtable, params, qflags)
        walls = []
        del seen[:]
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_query(qtable, params, qflags)
            walls.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(walls, [25, 50, 75])
        names = sorted({k for t in seen for k in t},
                       key=lambda k: -np.median([t.get(k, 0.0)
                                                 for t in seen]))
        phases = ", ".join(
            f"{k} {np.median([t.get(k, 0.0) for t in seen]) * 1e3:.3f}"
            for k in names)
        out.append(f"{root}: {label} warm wall median of {n} {med:.3f} ms "
                   f"(quartiles {q1:.3f}, {q3:.3f}; walls "
                   f"{[round(w, 3) for w in walls]}); phase medians, ms: "
                   f"{phases}")
    return "\n".join(out)


def main(argv: list[str]) -> int:
    only = ()
    if argv[:1] == ["--only"] and len(argv) > 1:
        only, argv = tuple(argv[1].split(",")), argv[2:]
    if len(argv) == 2 and argv[0] == "--one":
        print(time_kernels(os.path.abspath(argv[1]), only), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--trace":
        root = os.path.abspath(argv[1])
        print(trace_runs(root, only) if only else trace(root), flush=True)
        return 0
    if len(argv) == 3 and argv[0] == "--one-walls":
        print(time_walls(os.path.abspath(argv[1]), argv[2]), flush=True)
        return 0
    walls = bool(argv) and argv[0] == "--walls"
    roots = argv[2:] if walls else argv
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if walls:
        table_dir = os.path.abspath(argv[1])
        build_walls_table(table_dir)
    for root in roots:
        # one process per root: each imports its own package
        cmd = ([sys.executable, os.path.abspath(__file__), "--one-walls",
                root, table_dir] if walls else
               [sys.executable, os.path.abspath(__file__),
                *(["--only", ",".join(only)] if only else []), "--one",
                root])
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
