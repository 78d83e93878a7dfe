#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sybil_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Phases (any failure exits non-zero before the result lines):
  1. print the card's name and power limit (nvidia-smi); build the CUDA
     kernels from sybil_tpu_torch/csrc, one nvcc per source, in parallel
  2. build an uptime table of N rows (default 8,388,608 = 128 full
     blocks) with the port's Table.ingest_columns and bench.py's
     generator and seed, and two user_sessions tables of N rows from
     scripts/fakedata/activity_generator.columns (its seed rule, 1M-row
     steps, as scripts/bench_configs.py builds it): the bulk table as
     generated, and the same rows stably sorted by time, as digestion
     orders a table; and config 5's two partitions of N / 2 rows each
     (bench_configs.py:64-98: userid ~ Zipf(1.2) folded over 200,000
     users, weights, seed 900 + p * 1000, 1M-row steps, device_batch 64);
     and a fourth uptime table of N rows with the `groups` set column, from
     this script's copy of scripts/fakedata/host_generator.py:columns
     (seed 1337 + start_index, 1M-row steps, its `now` fixed to
     BENCH_NOW), built in a process of its own beside the others
  3. K1 decode_bucket2 against its plain PyTorch version on the card,
     bit for bit: the table's real host and ping containers, then edge
     blocks (u8/u16/i32 deltas, short, missing, invalid rows); K6
     decode_value on both user_sessions tables' time containers (value
     encoded) and the host decoder; then edge batches through
     decode_column_batch, each kernel against its plain version: value
     blocks with int8/16/32/64 deltas, large bases, invalid rows, short
     and missing blocks, str-id blocks of 6000 distinct values, bucket-v1
     blocks (K1's v1 mode, ids out of range), and a batch mixing kinds;
     K6's id mode on K6_CASES and its value mode on K6V_CASES (each
     delta type, C 128 to 262,144, short and one-record blocks, no valid
     entry, int64 sums that wrap, -1 and -2 rows into a poisoned output;
     k6_edge_checks)
  4. K2 dense_scan, K4 dense_hist, K5 outlier_compact and K3 dense_pack
     against their plain versions, word for word: on the decoded uptime
     batch (group by host avg ping, a weight column, three keys whose sum
     table exceeds shared memory, a value-biased int32-packed config,
     partial blocks, a spilling key bound; config 3 `status eq 200, group
     by host, hist ping` and its -loghist form), on the decoded
     user_sessions batch (config 2), on config 4 `group by action, avg
     weight, 1 h time buckets` over both user_sessions tables and over
     the bulk table's rows shuffled into arrival order (K2's windowed and
     global forms each), its -op hist form with outlier rows, then
     synthetic edge batches (MISSING and negative keys, invalid and
     out-of-bound values, zero and invalid weights, no groups, near 8192
     slots, non-compact tables; every filter op, weighted hists,
     multihist sub-outliers, more outliers than the packed section holds,
     a hist table in global memory; negative times, times beyond 2^31,
     spilled quotients, rows without the time column, a span wider than
     8 bands, a time rollup's tracked outliers); K2's windowed form on
     its corner cases (K2W_CASES: spans wider than the shared budget,
     sparse and dense, every row on one slot, no matched row, rows on the
     dead slot, a spilled quotient, a hist with the mask and the
     cache-group key, wrapping weighted lanes) and config 4's three
     layouts, word for word, each path of its design (resident,
     full-span, banded, direct, empty) taken; K4 on its corner cases
     (K4_CASES: one bucket of one gid, wrapping weights, a multihist
     value past its sub's array, discard bounds, a bucket size past 32
     bits, the dead gid, a table at the shared limit and one word past
     it) and K13 on its (K13_CASES: rank 51, MISSING values,
     str ids out of range, one register for every row, 3, 8, 12, 13 and
     128 planes, the dead slot), bit for bit, each table or form of each
     taken (their CTA counts).  Then the sorted strategy:
     K7 sorted_front, sort_permute, K8 segment_reduce, K9's hist_prep and
     hist_pairs (its hp_bv, hp_w and hp_keys at the rows hp_mask sets and
     at row R-1, the rows it writes), K5 over the sorted keys and K10
     sorted_pack against their
     plain versions, word for word, on this slice's two paths (path 1:
     config 3 with -tdigest, an int32 packed key, its (host, ping) pairs
     against numpy; path 2: config 4 at 5-minute buckets, 80,660 slots
     past the dense cap, on both user_sessions tables) and on synthetic
     sorted batches (int64 packed keys, a packed spill, values at min - 1,
     three unpacked keys with MISSING and negative values, both time
     divisions, weights and filters, multihist and value-identity layouts
     with live outliers, groups past prefix_rows, pairs past Hcap, the
     group cap, no keys); K7 alone on its corner cases (K7_CASES: packed
     int32 and int64 keys, a packed spill, values at min - 1, MISSING and
     negative unpacked keys, time keys in int32 and int64 arithmetic with
     negative times, distinct lanes, the cache-group lane with and
     without a time key, a packed key with the cache-group lane and under
     a time key, every filter op, an unknown op, 17 filters, the
     descriptor past its head unpacked and packed, the mask packed and
     unpacked, the enum form with wrapping weights and with a spill, 12-
     and 320-row batches, one zero lane) and a seeded random sweep of 32
     shapes, each unpacked batch's sort_rows with its sort_permute steps
     and sort_permute's own cases (PERMUTE_CASES), word for word, every
     template choice of K7 taken (k7_edge_checks).  K10 sorted_pack (its
     table, pair, distinct, prune and merged forms) and enum_pack, then K3
     dense_pack (compact, HLL, hist and merged forms) and dense_keyed, on
     synthetic tables at their wrappers' interfaces (K10_CASES, K3_CASES:
     no pairs, exactly and more than Hcap pairs, distinct pairs past
     max_pairs, masks off 16-byte alignment, W past 32, descriptors past
     their head, Ph and Phll above the live slots, odd int32 wire
     columns, prune ties and dead slots, time keys, 8,192 slots) and a
     24-shape sweep each, word for word on a `main` filled with FILL
     first: K5's rows, and the pruned prefix until K12's gather, must
     stay FILL (k10_edge_checks, k3_edge_checks); K7 to K10 on K9's
     corner cases (K9_CASES: a pair segment across 160 tiles, weighted
     and counted, segments on tile, chunk and thread edges, every row
     unmatched, every row in the sentinel segment, row R-1 a valid
     segment start, the last segment ending on row R-1 across tiles,
     weights of +-2^62, multihist sub-ranges, both pair-key widths at
     (S+1)nv just under and at 2^31; hist_pairs held at the rows its
     readers read; fails unless its look-back and one past 128 tiles
     ran; k9_edge_checks) and K5 on its own (K5_CASES: no live row,
     exactly kmax, past kmax, a live row R-1, tile edges, the cache-group
     and time keys, kmat keys with and without columns, max_out 5, a
     batch shorter than kmax, a 600-word row; k5_edge_checks); after the
     kernel table each form's device operations a call (K3, each form of
     K13, K11, hist_prep and K5: 1; K10, each table of K4, K6's value
     mode and hist_pairs: at most 2; late_op_checks).  Then the
     enumerated strategy: K7's enum form,
     K11 enum_segments, K12 topk_rows and K10's enum_pack against their
     plain versions on config 5's real batches of both partitions ($COUNT
     and f32 mean scores, the mean's winners against numpy) and on
     synthetic enumerated batches (ties across k, fewer live groups than
     k, R below the prefix, a packed spill, filters with MISSING keys, two
     keys with a weight column, mean scores with and without a value
     bias, every row unmatched), K12 alone on tie pile-ups, -inf ties,
     int64 scores and k = R, K12's general form on its corner cases
     (K12G_CASES: all-equal scores, also past a candidate buffer,
     INT64/INT32 extremes and f32 infinities, 56 shared top bits, config
     5's count ties straddling k and mean ties past it, k 4,096, k = R,
     R = 1) and a seeded 24-shape sweep (k12g_edge_checks), K11 on its
     corner cases (K11_CASES: a segment across more than 32 ranges,
     segments of a range's length, every row its own segment, every row
     unmatched, R not a multiple of the range, sums that wrap, acnt 0
     under prune_agg, 33 aggregations; both score forms each; fails
     unless every path of scan.K11_PATHS ran; k11_edge_checks), and the
     sorted strategy's device prune (K10's
     prune form, then K12 over the slots and its gather in one launch,
     prune_topk_gather) on config 5's batch.
     Then count distinct: K13 hll_registers and K3's HLL sections on the
     uptime batch (group by host, distinct index_int: the int hash; by
     host, distinct status: a str column's hash array, the reference's
     pair form; by status, distinct host with the hash array padded past
     the pair form: its row form), K7's distinct lanes, the sorts, K8's
     pair mask and K10's pair section (group by host, distinct status,
     ping; config 5's partition 1 by userid, distinct weight, past the
     packed pair rows), and synthetic batches (MISSING, negative and
     INT64_MIN/MAX distinct values, every row unmatched, more live slots
     than the shipped planes, hashes with rest == 0, a time-bucketed
     distinct with filters, D = 2, pairs with a hist agg), and the former
     fixed caps: K2, K5, K7, K8, K10 and K11 at 17 filters, 17 keys and 33
     aggregations, and K2, K7, K8 and K11 past the descriptor words a
     launch carries in its parameters (60 filters, 50 and 60 aggregations).
     Then set filters and samples: K14 set_match on the sets table's
     batch (each set value and an unknown literal, has and hit also
     against numpy) and five edge CSRs; K2's shared and global forms with
     S1's and S2's set filters, with and without the matched mask, its
     windowed form on a synthetic rollup; K7's sorted form on S3, S4b and
     S3 with the mask, its enum form on a synthetic batch with a set filter
  5. the main path through the port's CLI on cuda, one batch of all
     blocks, the launch counts reset just before each query and read just
     after: config 1 `-group host -int ping -op avg`, config 3 (and with
     -loghist), config 2 and config 4 on both user_sessions tables (cold:
     K1 twice, K6, K2, K3 once each); every group's count, sum and bucket
     counts, and every (time bucket, action) row's count and weight sum,
     against a numpy group-by of the generated arrays; then path 1 (each
     host's count, kept rows, the (host, ping) pairs the engine absorbs
     and the percentiles of a t-digest of numpy's pairs), path 2 on both
     tables (every (5-minute bucket, action) row's count and weight sum),
     a small table whose dense key bound spills, retried on the sorted
     strategy, against numpy; config 5: `query -encode-results` on each
     partition (K7, K11, K12 and K10 once per batch, K8 never; each
     shipped group and the Cumulative row against numpy), `aggregate`
     over the two result directories (the printed counts are numpy's
     top 100, each group's count and mean against numpy), the
     -prune-sort weight form (the printed users are numpy's top 100 by
     the f32 mean score) and a 4-batch form; the sorted device prune
     (one user's rows of partition 1 grouped by the second: K7, K8,
     K10, K12 and its gather once, the 100 busiest seconds in order
     against numpy); count distinct: -group host -distinct index_int and
     -distinct status (K13 once), -group host,status -op distinct (D = 2
     pairs) and config 5's partition 1 -group userid -distinct weight
     (the pair escalation), every printed Distinct against a port HLL fed
     the numpy values of its group.  At the default rows the launches over
     these queries must be K10 82, enum_pack 7, K3 71, dense_keyed 66, K4
     63 and K13 20 (MAIN_LAUNCHES).  Then cold and warm queries
     through run_query for each config and path, checking via the counts that
     warm queries run no decode (residency) and the scan kernels once per
     batch, also through a three-batch pipeline, the four distinct queries
     included (the device HLL's merged registers against the numpy-fed
     HLLs byte for byte); then S1-S5 on the sets table: S1 `-group host
     -int ping -op avg -set-filter groups:in:mod3`, S2 (`groups:nin:mod2`
     and `status:eq:200`), S3 (`-group host,status -op hist -tdigest`,
     `groups:in:mod5`: the sorted strategy), S4a and S4b (`-samples
     -limit 10`, K2's and K7's masks: the first matched rows in block
     order, read back with the port's blocks module) and S5 (an unknown
     literal: no row, every row), each against numpy, K14 once per set
     filter; then the query cache on a copy of the uptime table (8 cache
     groups of 16 full blocks): scripts/bench_cache.py's 15 shapes, and
     -tdigest and -loghist ones, each through run_query uncached, as a
     write on an empty cache directory and as a hit, write and hit equal
     to the uncached answer (group_avg also to numpy), every group hit
     and no kernel launched on the hit; the CLI's -cache-queries written
     and hit; group_avg at device_batch 16 (one K2 a group); 16 appended
     blocks (8 hits, 1 miss); K2 (all three forms), K4, K5, K3, K13, K7,
     sort_permute, K8, K9 and K10 with the cache-group key against their
     plain versions at the writes' own vgroup shapes and on seven
     synthetic batches (vg_first with the windowed form, padding groups,
     spills, the sorted strategy packed and unpacked); the sweep's warm
     walls (median of 5 each of uncached, write and hit), the phases of
     group_avg's and time_avg's write and hit, K2 with and without the
     cache-group key on the same batch, K7, the sorts, K8 and K5 at the
     vgroup shapes.  Then the mesh scan at -data-shards 8, one batch (16
     blocks a shard): MULTICHIP_r05.json's sharded shapes at full size
     (config 3 with -loghist outliers, config 4 at 1 h buckets (dense
     windowed), path 2 (sorted, about 72,590 groups), -group host,status
     -op distinct (the pairs), S1's set filter, S4a and S4b (the samples
     and their mask), config 5's partition 1 under the sorted device
     prune) and config 1, through run_query (config 1 also through the
     CLI): first once with K15, K16's shuffle_keys, shuffle_reduce and
     shuffle_unpack, K12's two-valued form, K3's keyed form and K10 on
     the merged table each held to its plain version bit for bit, then
     cold and five warm walls beside five unsharded warm walls, the
     launches per mesh query (the shard scans once per shard; K15, K16's
     shuffle_keys and shuffle_reduce once over all shards or owners, the
     unpack and the pack once), every
     answer equal to the
     unsharded one (config 5: the printed counts, each kept user's count
     and mean against numpy) and to numpy's where the earlier phases have
     one (configs 1 and 4, path 2, S1); then the exchange over an NCCL
     process group of world size 1 against the local exchange: config 3
     -loghist's and path 2's whole sharded scans, packed word for word,
     and a random buffer through all_to_all and all_gather; K15's corner
     cases (k15_edge_checks: a shard with no live row, overflow, D = 1,
     D = 6, 2 of 8 shards, multi-tile dense and sorted tables, int64
     keys whose halves both matter) held shard by shard to its plain
     version word for word; K16's corner
     cases (k16_case_rows: no live row, one key, INT64_MAX keys tied
     with dead rows, segments past the cap, MISSING keys, a 5,000-row
     segment, path 2's 201,024-row owner with a segment across tiles,
     without and with a tied row) at WP 174, 9 and 10, each entry held
     to its plain version word for word, rows tied with the dead rows'
     keys and not, and one stacked call over 8 owners at each width
     (an all-dead and an empty owner among them) against the plain
     version owner by owner;
     K2's windowed form at the mesh's first windowed shard, and K12's
     two-valued form on its corner cases (K12_CASES: all zeros, all
     ones, k below, at and above the ones, k = R, R = 1, R at the
     one-CTA limit of 16,384 flags and either side, many tiles) and at
     the mesh's compactions, word for word, with torch.profiler's device
     launches a call: 1 up to 16,384 flags, 2 above.
     Then the row store on copies of the uptime and sets tables: an
     undigested tail through the port's `ingest -skip-compact` (16 logs
     of 65,536 records from bench.py's generator continued at the
     table's last row, with two hosts the blocks lack, pings above the
     blocks' max inside the discard window and a weight past the blocks'
     key bound; 65,536 records on the sets table), every log decoded by
     the native WAL decoder; config 1, config 3 -loghist, a 1 h rollup,
     path 1, -distinct index_int, host and weight (the sorted retry of a
     spilled pseudo-block), config 1 at -data-shards 8 and S1 through
     the CLI with -read-log against numpy over the blocks and the tail,
     K3's keyed form of each pseudo-block's own table (`dense_keyed`)
     held to its plain version word for word, and the rowstore phase's
     launches of K2 and `dense_keyed` on cuda and its sorted retry
     counted; config 1 -read-log's cold and warm walls and phases; the
     keyed form on seven synthetic configs (no keys, a time key, MISSING
     and negative keys, compact and full reduce spaces, hist and HLL
     sections, an untracked aggregation, a weight column); then `python
     -m sybil_tpu_torch digest` of both tails, and each query without
     -read-log equal to its -read-log answer before the digest.
     Then the host tools (tools_phase; its queries' launches printed,
     not added to the main path's): on a copy of the uptime table config
     1, `index` (the table's ping and time min/max equal numpy's, config
     1's bytes unchanged), `rebuild` of a deleted info.json (new key
     ids; config 1 equal to numpy in this process and in a fresh
     `python -m sybil_tpu_torch query`), the client API's group-by on
     cuda in process and as a subprocess; on a copy of the first 16
     blocks `query -update-info`, `trim -mb` (the blocks numpy's ranking
     names), calculate_icc of a hist group-by on cuda and on the CPU
     (1e-12 relative, the hists equal), `trim -before -delete -really`
     and config 1 over the blocks left, `query -export` (every TSV equal
     to numpy's); `inspect` of the table info, a block info, a column, a
     dictionary and a WAL log of 65,536 records; each step's wall
  6. timings: query walls (median of 5) and rows/s, and the engine's
     phase breakdown of one cold and one warm query, per config; each
     kernel's time from CUDA events beside its bound (the larger of
     bytes / 3.35 TB/s and integer operations / the INT32 rate), its
     plain version's time and, where one torch call computes the same
     function, that call's time; K2 on config 4 in both forms per table,
     also queued (device time) with its device launches a call;
     K7, sort_permute, K8, K9, K5 (sorted keys) and K10 at both paths'
     shapes (K7 and sort_permute also queued, with their device
     operations a call), config 5's K7 enum form (also queued), K11,
     K12 ($COUNT and mean scores),
     K10 enum_pack and the device prune's forms, `aggregate`'s wall, K13
     on both hash paths (beside scatter_reduce_ amax), K3's HLL sections,
     the pairs' K7, K8 and K10, K5 over the sorted keys, and the stable
     torch.sort calls between them on lines of their own with their
     radix-pass bound; S1's cold and warm walls and S2-S4b's phases, K14
     beside its plain version and two index_add_ passes, K2 at S1's shape
     and K7 at S3's and S4b's with and without the set filter and mask;
     the cache-group forms of K2, K8 and K5 beside their torch calls;
     K15 over config 3 -loghist's and path 2's 8 shards (one call, beside
     the argsort and index_copy_ over the same shards; queued, with its
     device launches), K16's entries at one
     owner, the owner's sorts, K12's compaction (also at config 5
     partition 1's, 2^18 group rows; queued, with its device launches)
     and the unpack at both,
     and K3's keyed form at config 3 -loghist, beside their plain
     versions and torch calls; K16's entries also queued behind a sleep
     kernel (their device time without the wrappers' host time) and
     through torch.profiler (their device launches per call); K3's
     keyed form at config 1's and config 3 -loghist's pseudo-blocks,
     back to back and queued, beside its plain version; the row store's
     ingest and digest rates

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 1 first.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# H100 SXM INT32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HOSTS = ["www.facebook.com", "www.yahoo.com", "www.google.com",
         "www.reddit.com", "github.com"]
STATII = ["200", "403", "404", "500", "503"]
BENCH_SEED = 1337               # bench.py:59 (fresh table)
BENCH_NOW = 1_755_000_000
STEP = 1_000_000
KERNELS = ("decode_bucket2", "decode_value", "dense_scan", "dense_hist",
           "outlier_compact", "dense_pack", "sorted_front", "segment_reduce",
           "hist_pairs", "sorted_pack", "enum_segments", "topk_rows",
           "hll_registers", "set_match", "shuffle_partition",
           "shuffle_reduce")
# the launch-counted wrappers: each source's, and those of a source's
# other kernels (sybil_tpu_torch/ops/kernels.py ENTRY_SOURCES)
ENTRY_SOURCES = {"sort_permute": "sorted_front", "enum_pack": "sorted_pack",
                 "hist_prep": "hist_pairs", "prune_gather": "topk_rows",
                 "shuffle_keys": "shuffle_reduce",
                 "shuffle_unpack": "shuffle_reduce",
                 "dense_keyed": "dense_pack"}
COUNTED = KERNELS + tuple(ENTRY_SOURCES)


def tally(launches: dict, *counts) -> None:
    """Adds launch counts (kernels.snapshot()s) to the main path's tally:
    every counted kernel, and K2's launches by form (their `forms`)."""
    for c in counts:
        for k in COUNTED:
            launches[k] += c[k]
        for k, n in getattr(c, "forms", {}).items():
            launches[k] = launches.get(k, 0) + n
C4_BUCKET = 3600                # scripts/bench_configs.py:152-153
P2_BUCKET = 300                 # config 4 zoomed in to 5-minute buckets
# this slice's two paths: config 3 with -tdigest, config 4 at 300 s
P1_ARGV = ["-group", "host", "-int", "ping", "-op", "hist", "-tdigest",
           "-str-filter", "status:eq:200"]
P2_ARGV = ["-group", "action", "-int", "weight", "-op", "avg", "-time",
           "-time-bucket", str(P2_BUCKET), "-time-col", "time"]
FILL = 0x5A5A5A5A5A5A5A5A        # poison for buffers a kernel must write
DEFAULT_ROWS = 8_388_608
# the pack kernels', K4's and K13's launches over phase 5's queries at
# the default rows
MAIN_LAUNCHES = {"sorted_pack": 82, "enum_pack": 7, "dense_pack": 71,
                 "dense_keyed": 66, "dense_hist": 63, "hll_registers": 20}
# config 5 (scripts/bench_configs.py:64-98, 171-201): group by userid, avg
# weight, the default -limit 100 and -prune-sort $COUNT, on each of two
# partitions, then `aggregate`
C5_CARD = 200_000
C5_ARGV = ["-table", "sessions_zipf", "-group", "userid", "-int", "weight",
           "-op", "avg", "-limit", "100"]
C5_BATCH = 64                   # bench_configs.py:478-479
C5_NOW = 1_755_000_000
# the sorted device prune on the main path: one user's rows of config 5's
# partition grouped by the second (about 2.4M values, a radix past
# ENUM_RADIX_CAP): the user's 100 busiest seconds
C5_USER = 10
C5_USER_ARGV = ["-table", "sessions_zipf", "-group", "time", "-int",
                "weight", "-op", "avg", "-limit", "100", "-str-filter",
                f"userid:eq:person{C5_USER}"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 2: the tables
# ---------------------------------------------------------------------------

def build_table(root: str, n_rows: int):
    """bench.py build_dataset's generator and seed, written by the port.
    Returns (Table, Flags, {"host", "status", "ping", "weight", "time":
    per-row arrays}, host and status as list indices)."""
    import numpy as np

    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table

    flags = Flags(dir=root, table="uptime", skip_compact=True,
                  device_batch=1024)
    t = Table("uptime", flags)
    rng = np.random.default_rng(BENCH_SEED)
    parts = {k: [] for k in ("host", "status", "ping", "weight", "time")}
    for start in range(0, n_rows, STEP):
        n = min(STEP, n_rows - start)
        hosts_idx = rng.integers(0, 5, n)
        stat_idx = rng.integers(0, 5, n)
        ints = {
            "ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
            "weight": rng.choice([1, 10, 100], n).astype(np.int64),
            "time": BENCH_NOW + rng.integers(-2419200, 2419200, n),
            "index_int": np.arange(start, start + n, dtype=np.int64),
        }
        t.ingest_columns(
            ints=ints, strs={"host": [HOSTS[i] for i in hosts_idx],
                             "status": [STATII[i] for i in stat_idx]})
        parts["host"].append(hosts_idx)
        parts["status"].append(stat_idx)
        for k in ("ping", "weight", "time"):
            parts[k].append(ints[k])
    return t, flags, {k: np.concatenate(v) for k, v in parts.items()}


def build_sessions(root: str, sorted_root: str, n_rows: int):
    """user_sessions from scripts/fakedata/activity_generator.columns,
    1M-row steps with start_index (scripts/bench_configs.py:38-61),
    written by the port; then the same rows stably sorted by time, as
    digestion orders a table (columnar.sort_batch_by_time), written in
    the same steps into a second, time-sorted table.  Returns (Table,
    Flags, sorted Table, its Flags, {"action", "page": list indices,
    "weight", "time"}, ACTIONS, PAGES)."""
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    from fakedata.activity_generator import ACTIONS, PAGES, columns

    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table

    flags = Flags(dir=root, table="user_sessions", skip_compact=True,
                  device_batch=1024)
    t = Table("user_sessions", flags)
    aidx = {s: i for i, s in enumerate(ACTIONS)}
    pidx = {s: i for i, s in enumerate(PAGES)}
    steps = []
    for start in range(0, n_rows, STEP):
        n = min(STEP, n_rows - start)
        ints, strs = columns(n, start_index=start)
        t.ingest_columns(ints=ints, strs=strs)
        steps.append((ints, strs))
    ints = {k: np.concatenate([st[0][k] for st in steps]) for k in steps[0][0]}
    strs = {k: [x for st in steps for x in st[1][k]] for k in steps[0][1]}
    del steps
    sflags = Flags(dir=sorted_root, table="user_sessions", skip_compact=True,
                   device_batch=1024)
    ts = Table("user_sessions", sflags)
    perm = np.argsort(ints["time"], kind="stable")
    for start in range(0, n_rows, STEP):
        sel = perm[start: start + STEP]
        ts.ingest_columns(ints={k: v[sel] for k, v in ints.items()},
                          strs={k: [v[i] for i in sel.tolist()]
                                for k, v in strs.items()})
    us = {"action": np.fromiter((aidx[x] for x in strs["action"]),
                                dtype=np.int64, count=n_rows),
          "page": np.fromiter((pidx[x] for x in strs["page"]),
                              dtype=np.int64, count=n_rows),
          "weight": ints["weight"], "time": ints["time"]}
    return t, flags, ts, sflags, us, ACTIONS, PAGES


def numpy_groupby(hosts, pings) -> dict:
    """{host: (count, Σping)} — the straightforward reference."""
    import numpy as np
    out = {}
    for i, h in enumerate(HOSTS):
        sel = hosts == i
        out[h] = (int(sel.sum()), int(pings[sel].sum(dtype=np.int64)))
    return out


def numpy_hist(gidx, ngroups: int, matched, v, agg) -> list:
    """Per group g < ngroups: {"count": matched rows, "n": kept rows,
    "sum": Σv of kept rows, "values": bucket counts [nv], "outliers":
    raw values that overflowed their bucket range}, for an unweighted
    histogram with the port's bucket layout (AggSpec: hist_min,
    bucket_size, num_values, sub_edges, discard bounds) — the
    straightforward reference of configs 2 and 3."""
    import numpy as np
    keep = matched & (v >= agg.discard_min) & (v <= agg.discard_max)
    R = len(v)
    bv = np.zeros(R, np.int64)
    contrib = keep.copy()
    out = np.zeros(R, bool)
    if agg.sub_edges:
        assigned = np.zeros(R, bool)
        for (smin, smax, sbs, snv, soff) in agg.sub_edges:
            inr = keep & ~assigned & (v >= smin) & (v <= smax)
            raw = (v - smin) // sbs                 # v >= smin: no sign
            out |= inr & (raw >= snv)
            bv = np.where(inr, np.clip(raw, 0, snv - 1) + soff, bv)
            assigned |= inr
        contrib = assigned
    else:
        x = v - agg.hist_min
        raw = np.where(x >= 0, x // agg.bucket_size,
                       -((-x) // agg.bucket_size))
        out = keep & (raw >= agg.num_values)
        bv = np.clip(raw, 0, agg.num_values - 1)
    nv = agg.num_values
    cells = np.bincount(gidx[contrib] * nv + bv[contrib],
                        minlength=ngroups * nv).reshape(ngroups, nv)
    res = []
    for g in range(ngroups):
        sel = gidx == g
        k = sel & keep
        res.append({"count": int((sel & matched).sum()), "n": int(k.sum()),
                    "sum": int(v[k].sum(dtype=np.int64)),
                    "values": cells[g].astype(np.int64),
                    "outliers": v[sel & out]})
    return res


def numpy_rollup(times, actions, weights, tb: int) -> dict:
    """{(time bucket, action index): (count, Σweight)}: config 4's
    straightforward reference (every generated row has all three
    columns; Go's truncating division)."""
    import numpy as np
    q = np.where(times >= 0, times // tb, -((-times) // tb))
    key = (q * tb) * 16 + actions
    uk, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    wsum = np.bincount(inv, weights=weights.astype(np.float64))
    if wsum.max() >= 2**53:
        fail("numpy_rollup: a weight sum is not exact in float64")
    return {(int(k // 16), int(k % 16)): (int(c), int(w))
            for k, c, w in zip(uk.tolist(), cnt.tolist(), wsum.tolist())}


def numpy_pairs(hosts, status, pings, agg) -> dict:
    """{(host, value): rows}: path 1's (group, value) pairs, the kept rows
    (status 200, ping inside the discard bounds) counted by host and by
    the lower edge of their bucket (the value itself when bucket_size is
    1) — the straightforward reference of -tdigest's sparse pairs."""
    import numpy as np
    keep = ((status == STATII.index("200")) & (pings >= agg.discard_min)
            & (pings <= agg.discard_max))
    v = pings[keep]
    edge = agg.hist_min + (v - agg.hist_min) // agg.bucket_size \
        * agg.bucket_size
    key = hosts[keep] * (1 << 40) + edge
    uk, cnt = np.unique(key, return_counts=True)
    return {(HOSTS[int(k) >> 40], int(k) & ((1 << 40) - 1)): int(c)
            for k, c in zip(uk.tolist(), cnt.tolist())}


def numpy_tdigest_percentiles(pairs: dict, host: str, agg) -> list:
    """The percentiles the engine prints for one host of a one-batch
    -tdigest query, from numpy's pairs: the host's (value, count) pairs in
    value order fed to one TDigest (as _absorb_hist_pairs feeds a batch),
    merged into a TDigestHist (as _make_result does)."""
    from sybil_tpu_torch.query.hist import TDigest, TDigestHist
    items = sorted((v, c) for (h, v), c in pairs.items() if h == host)
    td = TDigest()
    td.add_many([v for v, _ in items], [c for _, c in items])
    h = TDigestHist(agg.discard_min, agg.discard_max // 10)
    h.count = sum(c for _, c in items)
    h.td.merge(td)
    return h.get_percentiles()


def spill_table(root: str):
    """A small table whose int group key g passes its IntInfo bound: the
    outlier-resistant IntInfo ignores one value of 1,000,000, and one
    block's exact bounds are removed, as a block written before they
    existed has none, so the bind keeps the IntInfo bound and the dense
    scan spills.  -> (directory, blocks, {g: (count, Σv)})."""
    import numpy as np

    from sybil_tpu_torch import codec, digest
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table
    rng = np.random.default_rng(77)
    n = 2048
    g = rng.integers(0, 20, n).astype(np.int64)
    g[1500] = 1_000_000
    v = rng.integers(0, 100, n).astype(np.int64)
    old = digest.CHUNK_SIZE
    digest.CHUNK_SIZE = 512
    try:
        Table("spill", Flags(dir=root, table="spill", skip_compact=True)
              ).ingest_columns(ints={"g": g, "v": v})
    finally:
        digest.CHUNK_SIZE = old
    blocks_ = sorted(b for b in os.listdir(os.path.join(root, "spill"))
                     if b.startswith("block"))
    info = os.path.join(root, "spill", blocks_[0], "info.json")
    meta = codec.read_json(info)
    meta["int_exact"] = {}
    codec.write_json_atomic(info, meta)
    want = {}
    for k in np.unique(g).tolist():
        sel = g == k
        want[str(k)] = (int(sel.sum()), int(v[sel].sum()))
    return root, len(blocks_), want


def build_zipf_partitions(root: str, n_rows: int):
    """Config 5's two directory 'nodes' as scripts/bench_configs.py:64-98
    builds them, written by the port: n_rows // 2 rows each in 1M-row
    steps, seed 900 + p * 1000 (p = 0, 1; nothing to resume), userid =
    person{zipf(1.2) % 200,000}, weight from {1, 10, 100}, time over the
    four weeks before 1,755,000,000; device_batch 64.  Below full size the
    blocks shrink so that each partition keeps more than 16 (the device
    prune's gate).  -> [(Table, Flags, uid int64 [n], weight int64 [n],
    time int64 [n])]."""
    import numpy as np

    from sybil_tpu_torch import digest
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.table import Table
    per = n_rows // 2
    chunk = 65536
    while chunk > 128 and per // chunk < 17:
        chunk //= 2
    out = []
    old = digest.CHUNK_SIZE
    digest.CHUNK_SIZE = chunk
    try:
        for p in range(2):
            flags = Flags(dir=os.path.join(root, f"db-p{p + 1}"),
                          table="sessions_zipf", skip_compact=True,
                          device_batch=C5_BATCH)
            t = Table("sessions_zipf", flags)
            rng = np.random.default_rng(900 + p * 1000)
            uids, ws, tms = [], [], []
            for start in range(0, per, STEP):
                m = min(STEP, per - start)
                uid = rng.zipf(1.2, size=m) % C5_CARD
                w = rng.choice([1, 10, 100], m).astype("int64")
                tm = C5_NOW + rng.integers(-2419200, 0, m)
                t.ingest_columns(
                    ints={"weight": w, "time": tm},
                    strs={"userid": [f"person{u}" for u in uid]})
                uids.append(uid.astype(np.int64))
                ws.append(w)
                tms.append(tm)
            t.load_info()
            out.append((t, flags, np.concatenate(uids), np.concatenate(ws),
                        np.concatenate(tms)))
    finally:
        digest.CHUNK_SIZE = old
    return out


def numpy_users(uid, w) -> tuple:
    """{user: rows} and {user: Σweight} of one partition's generated
    arrays, as int64 [C5_CARD] arrays: config 5's straightforward
    reference."""
    import numpy as np
    cnt = np.bincount(uid, minlength=C5_CARD).astype(np.int64)
    wsum = np.bincount(uid, weights=w.astype(np.float64),
                       minlength=C5_CARD)
    if wsum.max() >= 2**53:
        fail("numpy_users: a weight sum is not exact in float64")
    return cnt, wsum.astype(np.int64)


def str_buckets(agg, values, outliers) -> dict:
    """The JSON `buckets` of a histogram with these counts: every bucket
    keyed by its lower edge (sub-ranges in order, later keys overwriting),
    each outlier value counted once more, zeros dropped (printer.py
    result_to_json over hist.py get_str_buckets)."""
    ret = {}
    if agg.sub_edges:
        for (smin, _smax, sbs, snv, soff) in agg.sub_edges:
            for k in range(snv):
                ret[str(k * sbs + smin)] = int(values[soff + k])
    else:
        for k in range(agg.num_values):
            ret[str(k * agg.bucket_size + agg.hist_min)] = int(values[k])
    for x in outliers.tolist():
        ret[str(x)] = ret.get(str(x), 0) + 1
    return {k: c for k, c in ret.items() if c > 0}


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

class MemContainer:
    """An encoded column held in memory, with codec.Container's reads."""

    def __init__(self, meta: dict, sections: dict):
        self.meta, self._s = meta, sections

    def read(self, name):
        return self._s[name]

    def __contains__(self, name):
        return name in self._s


def k1_inputs(containers, C: int, device):
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.decode import bucket2_batch
    idx = [i for i, c in enumerate(containers) if c is not None]
    arrays = bucket2_batch(containers, idx)
    src = np.full(len(containers), -1, dtype=np.int32)
    src[idx] = np.arange(len(idx), dtype=np.int32)
    return [torch.from_numpy(a).to(device) for a in (*arrays, src)]


def max_abs_diff(a, b) -> float:
    import torch
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool:
        return float((a != b).sum().item() > 0)
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()
                 .item()) if a.numel() else 0.0


def check_equal(what: str, got, want, errs: list) -> None:
    import torch
    ok = got.shape == want.shape and torch.equal(got, want)
    err = max_abs_diff(got, want)
    errs.append(err)
    if not ok:
        fail(f"{what}: kernel differs from its plain version "
             f"(max abs diff {err})")


def k1_check(what: str, containers, C: int, device, errs: list):
    from sybil_tpu_torch.ops.decode import decode_bucket2, decode_bucket2_plain
    ins = k1_inputs(containers, C, device)
    got = decode_bucket2(*ins, C)
    want = decode_bucket2_plain(*ins, C)
    check_equal(f"K1 {what} values", got[0], want[0], errs)
    check_equal(f"K1 {what} valid", got[1], want[1], errs)
    return ins, got


def edge_containers():
    """Encoded edge blocks -> list of (label, containers, C)."""
    import numpy as np

    from sybil_tpu_torch.blocks import (IntColumnData, StrColumnData,
                                        encode_int_column, encode_str_column)
    rng = np.random.default_rng(7)

    def int_block(n, card, p_valid, spread=1):
        v = rng.integers(0, card, n).astype(np.int64) * spread
        m = rng.random(n) < p_valid
        meta, s = encode_int_column(IntColumnData(v, m))
        if meta["encoding"] != "bucket" or "seg_bases" not in s:
            fail("edge block is not bucket v2")
        return MemContainer(meta, s)

    def rare_block(n):
        # one value every ~1000 rows: gaps beyond 255 need uint16 deltas
        v = np.zeros(n, dtype=np.int64)
        v[::997] = 1
        meta, s = encode_int_column(IntColumnData(v, np.ones(n, bool)))
        if s["id_deltas"].dtype != np.uint16:
            fail("the rare-value edge block did not take uint16 deltas")
        return MemContainer(meta, s)

    def str_block(n, card):
        ids = rng.integers(0, card, n).astype(np.int32)
        m = rng.random(n) < 0.9
        meta, s = encode_str_column(
            StrColumnData(ids, m, [str(i) for i in range(card)]))
        return MemContainer(meta, s)

    def widen(c):
        s = {k: c.read(k) for k in ("uniq", "offsets", "id_deltas",
                                    "seg_bases")}
        s["id_deltas"] = s["id_deltas"].astype(np.int32)
        return MemContainer(c.meta, s)

    u8 = int_block(65536, 5, 0.97)
    return [
        ("u8 full blocks", [u8, int_block(65536, 150, 0.99)], 65536),
        ("u16 deltas", [rare_block(65536), u8], 65536),
        ("i32 deltas", [widen(int_block(65536, 40, 0.8)), u8], 65536),
        ("short blocks", [int_block(1000, 7, 0.9), int_block(1, 1, 1.0),
                          str_block(777, 3)], 1024),
        ("missing blocks", [None, int_block(4000, 12, 0.5), None,
                            str_block(65536, 4999)], 65536),
        ("invalid rows", [int_block(65536, 3, 0.01),
                          int_block(30000, 2000, 0.5, spread=-3)], 65536),
    ]


def k6_inputs(containers, C: int, device):
    """K6 value-mode inputs of value containers (all present)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.decode import value_batch
    idx = list(range(len(containers)))
    arrays = value_batch(containers, idx, C)
    src = np.arange(len(idx), dtype=np.int32)
    return [torch.from_numpy(a).to(device) for a in (*arrays, src)]


def decode_check(what: str, containers, C: int, device, errs: dict):
    """decode_column_batch on the card (one kernel launch per encoding,
    each writing its own rows) against the same call with every kernel
    swapped for its plain version, on the same card tensors."""
    from sybil_tpu_torch.ops import decode
    kinds, _ = decode.classify_containers(containers, C)
    got = decode.decode_column_batch(containers, C, device)
    names = ("decode_bucket2", "decode_bucket_v1", "decode_value",
             "decode_ids")
    kernels_ = {n: getattr(decode, n) for n in names}
    try:
        for n in names:
            setattr(decode, n, getattr(decode, n + "_plain"))
        want = decode.decode_column_batch(containers, C, device)
    finally:
        for n, f in kernels_.items():
            setattr(decode, n, f)
    used = {"decode_bucket2" for k in kinds if k in ("bucket2", "bucket")}
    used |= {"decode_value" for k in kinds if k in ("value", "str_value")}
    for k in used:
        check_equal(f"{k} {what} values", got[0], want[0], errs[k])
        check_equal(f"{k} {what} valid", got[1], want[1], errs[k])
    return sorted(set(kinds))


def v1_container(rng, n: int, card: int, p_valid: float, shift: int = 0):
    """A bucket-v1 block as the v1 encoder wrote it (cross-segment id
    deltas from an id_base meta, no seg_bases; tests/test_storage.py:
    181-215); shift moves ids out of [0, n) to exercise the clamp."""
    import numpy as np

    from sybil_tpu_torch.blocks import _narrow
    values = rng.integers(0, card, n).astype(np.int64)
    valid = rng.random(n) < p_valid
    rows = np.nonzero(valid)[0].astype(np.int64)
    order = np.argsort(values[rows], kind="stable")
    sorted_rows = rows[order]
    uniq, starts = np.unique(values[rows][order], return_index=True)
    offsets = np.empty(len(uniq) + 1, dtype=np.int32)
    offsets[:-1] = starts
    offsets[-1] = len(sorted_rows)
    deltas = np.zeros(len(sorted_rows), dtype=np.int64)
    deltas[1:] = sorted_rows[1:] - sorted_rows[:-1]
    return MemContainer(
        {"type": "int", "encoding": "bucket", "num_records": n,
         "cardinality": len(uniq), "id_base": int(sorted_rows[0]) + shift,
         "version": 1},
        {"uniq": uniq.astype(np.int64), "offsets": offsets,
         "id_deltas": _narrow(deltas)})


def b5_edge_containers():
    """Value, str-id, v1-bucket and mixed edge batches -> list of
    (label, containers, C)."""
    import numpy as np

    from sybil_tpu_torch.blocks import (IntColumnData, StrColumnData,
                                        encode_int_column, encode_str_column)
    rng = np.random.default_rng(11)

    def value(n, step_lo, step_hi, base, p_valid, want_dt):
        steps = rng.integers(step_lo, step_hi, n).astype(np.int64)
        steps[steps == 0] = 1
        v = base + np.cumsum(steps)
        meta, s = encode_int_column(IntColumnData(v, rng.random(n) < p_valid))
        if meta["encoding"] != "value" or (
                want_dt and s["deltas"].dtype != np.dtype(want_dt)):
            fail(f"edge value block: {meta['encoding']} "
                 f"{s.get('deltas', np.zeros(0)).dtype}, not {want_dt}")
        return MemContainer(meta, s)

    def str_ids(n, card, p_valid):
        ids = rng.integers(0, card, n).astype(np.int32)
        meta, s = encode_str_column(StrColumnData(
            ids, rng.random(n) < p_valid, [f"u{i}" for i in range(card)]))
        if meta["encoding"] != "value":
            fail("edge str block is not value-encoded")
        return MemContainer(meta, s)

    def bucket2(n, card):
        meta, s = encode_int_column(IntColumnData(
            rng.integers(0, card, n).astype(np.int64), rng.random(n) < 0.9))
        return MemContainer(meta, s)

    C = 65536
    return [
        ("value i8 deltas", [value(C, 1, 100, 1 << 40, 1.0, "i1"),
                             value(C, -100, 120, -(1 << 41), 1.0, "i1")], C),
        ("value i16 deltas", [value(C, -3000, 30000, 1_755_000_000, 1.0,
                                    "i2")], C),
        ("value i32 deltas, invalid rows",
         [value(C, -2_000_000, 2_000_000, 1_755_000_000, 0.7, None),
          value(C, 1, 100, 5, 0.6, None)], C),
        ("value i64 deltas", [value(C, -(1 << 40), 1 << 40, 1 << 50, 1.0,
                                    "i8")], C),
        ("value short and missing blocks",
         [None, value(5100, 1, 50, 1 << 33, 0.99, None), None,
          value(60000, -40, 90, -(1 << 35), 0.9, None)], C),
        ("str ids, 6000 distinct", [str_ids(C, 6000, 0.9),
                                    str_ids(7000, 6000, 0.97), None], C),
        ("bucket v1", [v1_container(rng, C, 50, 0.9),
                       v1_container(rng, 40000, 7, 0.8),
                       v1_container(rng, 700, 3, 1.0)], C),
        ("bucket v1, ids shifted out of range",
         [v1_container(rng, 4096, 9, 0.8, shift=-100),
          v1_container(rng, 4096, 4, 0.9, shift=300)], 4096),
        ("mixed kinds", [value(C, 1, 100, 1 << 40, 0.9, None),
                         bucket2(C, 12), None, v1_container(rng, 6000, 20, 0.8),
                         str_ids(C, 6000, 0.9),
                         value(60000, -3000, 30000, -5, 0.95, None), None,
                         bucket2(3000, 40)], C),
    ]


# K1's corner cases (tests/test_torch_decode.py holds the plain version
# and the column batch to the reference's _decode_bucket2_jit,
# _decode_bucket_jit and decode_column_batch on the same cases): name ->
# (blocks, C).  A block is None (the block lacks the column), ("value",
# n): an int block of value-encoded deltas (a row of another launch: -2
# in the bucket launches), or (layout, n, values, p_valid, options): a
# bucket block of n rows in layout "v2" or "v1", its values drawn from
# `values` distinct ones ("one": a single value; "rare": a second value
# every 997th row; "cap": every value of 8,192 eight times, the K cap),
# options dtype (the deltas' type; default the v2 encoder's or the v1
# narrowing) and shift (every row id moved: v2 seg_bases, v1 id_base).
# On the card (units of 2,048 postings, 32 a block of
# 65,536) the few-valued and one-valued blocks' segments cross unit edges,
# and the v1 blocks carry a prefix through every unit.
K1_CASES = {
    "uint8 deltas": ([("v2", 65536, 5, 0.97, {})], 65536),
    "uint16 deltas": ([("v2", 65536, "rare", 1.0, {})], 65536),
    "int32 deltas": ([("v2", 65536, 40, 0.8, {"dtype": "int32"})], 65536),
    "int8 deltas": ([("v2", 65536, 5, 0.97, {"dtype": "int8"}),
                     ("v2", 30000, 5, 0.9, {"dtype": "int8"})], 65536),
    "int16 deltas": ([("v2", 65536, "rare", 1.0, {"dtype": "int16"})],
                     65536),
    "int64 deltas": ([("v2", 65536, 150, 0.99, {"dtype": "int64"})], 65536),
    "v1 layout": ([("v1", 65536, 50, 0.9, {}), ("v1", 40000, 7, 0.8, {}),
                   ("v1", 100, 3, 1.0, {"dtype": "int8"}),
                   ("v1", 20000, 9, 0.9, {"dtype": "int16"})], 65536),
    "segments across unit edges": ([("v2", 65536, 3, 0.95, {}),
                                    ("v2", 65536, 2, 0.5, {})], 65536),
    "one value a block": ([("v2", 65536, "one", 1.0, {}),
                           ("v2", 50000, "one", 0.6, {})], 65536),
    "K at the 8,192 cap": ([("v2", 65536, "cap", 1.0, {})], 65536),
    "missing and skipped blocks": ([("v2", 65536, 5, 0.9, {}), None,
                                    ("value", 65536),
                                    ("v2", 3000, 7, 0.9, {}), None], 65536),
    "ids outside [0, C)": ([("v2", 4096, 9, 0.8, {"shift": -100}),
                            ("v2", 4096, 4, 0.9, {"shift": 300}),
                            ("v1", 4096, 9, 0.8, {"shift": -100}),
                            ("v1", 4096, 4, 0.9, {"shift": 300})], 4096),
}


def k1_block(rng, spec):
    """One block of a K1 case (K1_CASES) as a MemContainer, or None."""
    import numpy as np

    from sybil_tpu_torch.blocks import (BLOCK_VERSION, IntColumnData, _narrow,
                                        encode_int_column)
    if spec is None:
        return None
    if spec[0] == "value":
        n = spec[1]
        meta, s = encode_int_column(IntColumnData(
            rng.integers(0, 10 ** 9, n).astype(np.int64), rng.random(n) < 0.9))
        if meta["encoding"] != "value":
            fail("K1 case: the value block is not value-encoded")
        return MemContainer(meta, s)
    layout, n, card, p_valid, opt = spec
    if card == "one":
        values = np.full(n, 7, np.int64)
    elif card == "rare":
        values = np.zeros(n, np.int64)
        values[::997] = 1
    elif card == "cap":
        values = rng.permutation(np.arange(n, dtype=np.int64) % 8192)
    else:
        values = rng.integers(0, card, n).astype(np.int64)
    valid = rng.random(n) < p_valid
    rows = np.nonzero(valid)[0].astype(np.int64)
    order = np.argsort(values[rows], kind="stable")
    srt = rows[order]
    uniq, starts = np.unique(values[rows][order], return_index=True)
    deltas = np.zeros(len(srt), np.int64)
    deltas[1:] = srt[1:] - srt[:-1]
    shift = opt.get("shift", 0)
    meta = {"type": "int", "encoding": "bucket", "num_records": n,
            "cardinality": len(uniq)}
    sections = {"uniq": uniq.astype(np.int64),
                "offsets": np.append(starts, len(srt)).astype(np.int32)}
    if layout == "v2":
        deltas[starts] = 0
        sections["seg_bases"] = (srt[starts] + shift).astype(np.int32)
        meta["version"] = BLOCK_VERSION
        hi = int(deltas.max()) if len(deltas) else 0
        dt = np.uint8 if hi < 256 else np.uint16 if hi < 65536 else np.int32
    else:
        meta.update(id_base=int(srt[0]) + shift, version=1)
        dt = _narrow(deltas).dtype
    dt = np.dtype(opt.get("dtype", dt))
    cast = deltas.astype(dt)
    if not np.array_equal(cast.astype(np.int64), deltas):
        fail(f"K1 case block {spec}: its deltas do not fit {dt}")
    sections["id_deltas"] = cast
    return MemContainer(meta, sections)


def k1_case(name: str, seed: int = 0):
    """K1's corner case `name` -> (containers, C)."""
    import numpy as np
    blocks_, C = K1_CASES[name]
    rng = np.random.default_rng(seed + sorted(K1_CASES).index(name))
    return [k1_block(rng, b) for b in blocks_], C


def k1_layout_inputs(containers, kind: str):
    """The inputs of one K1 launch over a case's blocks of `kind`
    ("bucket2" or "bucket", as classify_containers names them): numpy
    (deltas, counts, offsets, uniq, bases, src_of_row), src -1 for a
    missing block and -2 for a block of another kind; None when the case
    has no such block."""
    import numpy as np

    from sybil_tpu_torch.ops import decode
    kinds, _ = decode.classify_containers(containers, 1 << 30)
    idx = [i for i, k in enumerate(kinds) if k == kind]
    if not idx:
        return None
    batch = decode.bucket2_batch if kind == "bucket2" else \
        decode.bucket_v1_batch
    src = np.array([-1 if k == "missing" else -2 for k in kinds], np.int32)
    src[idx] = np.arange(len(idx), dtype=np.int32)
    return (*batch(containers, idx), src)


def k1_edge_checks(card, device, errs) -> None:
    """K1 on the card over K1_CASES, each launch (v2 and v1) held to its
    plain version bit for bit, the rows another launch owns left as they
    were, and each case's column batch (decode_check); fails unless a
    unit's first segment began in an earlier unit (a cut segment) and a
    look-back read past one unit (decode.K1_PATHS)."""
    import torch

    from sybil_tpu_torch.ops import decode
    total = dict.fromkeys(decode.K1_PATHS, 0)
    for name in K1_CASES:
        containers, C = k1_case(name)
        for kind, kern, plain in (
                ("bucket2", decode.decode_bucket2,
                 decode.decode_bucket2_plain),
                ("bucket", decode.decode_bucket_v1,
                 decode.decode_bucket_v1_plain)):
            ins = k1_layout_inputs(containers, kind)
            if ins is None:
                continue
            ins = [torch.from_numpy(x).to(device) for x in ins]
            B = len(containers)
            # rows of another launch keep what the buffers held
            out = (torch.full((B, C), FILL, dtype=torch.int64,
                              device=device),
                   torch.ones((B, C), dtype=torch.bool, device=device))
            outp = (out[0].clone(), out[1].clone())
            paths = torch.zeros(len(decode.K1_PATHS), dtype=torch.int64,
                                device=device)
            kern(*ins, C, out=out, paths=paths)
            plain(*ins, C, out=outp)
            check_equal(f"K1 case {name!r} {kind} values", out[0], outp[0],
                        errs["decode_bucket2"])
            check_equal(f"K1 case {name!r} {kind} valid", out[1], outp[1],
                        errs["decode_bucket2"])
            for k, n in zip(decode.K1_PATHS, paths.tolist()):
                total[k] += n
        decode_check(f"K1 case {name!r}", containers, C, device, errs)
    if not all(total.values()):
        fail(f"K1's paths {total}: each must run")
    say(f"[{card}] K1 == plain bit for bit on {len(K1_CASES)} corner cases "
        f"(both layouts, six delta types; the column batches too); paths "
        f"{total}")


# K6's id mode: name -> (blocks, C).  A block is None (the block lacks
# the column), ("ids", n, p_valid): a str column past
# CARDINALITY_THRESHOLD (6,000 distinct strings), ("neg", n): ids below
# 0 as well (the widening sign-extends), or ("value", n): an int column
# of value-encoded deltas (more than 5,000 distinct values), whose launch
# runs before the ids' and zeroes the missing rows, so the id launch
# leaves them (-2) rather than zeroes them (-1)
K6_CASES = {
    "one block, C 128": ([("ids", 100, 0.9)], 128),
    "one block, C 65,536": ([("ids", 65536, 0.9)], 65536),
    "blocks shorter than C": ([("ids", 700, 0.8), ("ids", 4096, 0.95),
                               ("ids", 1, 1.0)], 4096),
    "all rows invalid": ([("ids", 4096, 0.0), ("ids", 3000, 0.0)], 4096),
    "negative ids": ([("neg", 4096), ("ids", 4096, 0.5)], 4096),
    "missing blocks, zeroed by the id launch": (
        [None, ("ids", 2000, 0.9), None, ("ids", 4096, 0.7)], 4096),
    "after a value-mode launch": (
        [("value", 8192), None, ("ids", 8192, 0.9), ("value", 6000), None,
         ("ids", 100, 0.5)], 8192),
}


def k6_case(name: str, seed: int = 0):
    """K6_CASES[name] encoded -> (containers, C): MemContainers of the
    port's encoders (a negative-id block written by hand, as no encoder
    writes one)."""
    import numpy as np

    from sybil_tpu_torch.blocks import (IntColumnData, StrColumnData,
                                        encode_int_column, encode_str_column,
                                        pack_bits)
    blocks_, C = K6_CASES[name]
    rng = np.random.default_rng(seed + sorted(K6_CASES).index(name))
    words = [f"user{i}" for i in range(6000)]
    out = []
    for blk in blocks_:
        if blk is None:
            out.append(None)
        elif blk[0] == "ids":
            _, n, p_valid = blk
            meta, sec = encode_str_column(StrColumnData(
                rng.integers(0, 6000, n).astype(np.int32),
                rng.random(n) < p_valid, words))
            out.append(MemContainer(meta, sec))
        elif blk[0] == "neg":
            n = blk[1]
            ids = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
            meta = {"type": "str", "encoding": "value", "num_records": n,
                    "cardinality": 6000}
            out.append(MemContainer(meta, {
                "ids": ids, "valid_bits": pack_bits(rng.random(n) < 0.9)}))
        else:
            n = blk[1]
            v = 1_755_000_000 + np.cumsum(rng.integers(1, 3000, n))
            meta, sec = encode_int_column(IntColumnData(
                v.astype(np.int64), rng.random(n) < 0.9))
            out.append(MemContainer(meta, sec))
        if out[-1] is not None and out[-1].meta["encoding"] != "value":
            fail(f"K6 case {name}: a block is {out[-1].meta['encoding']}-"
                 f"encoded, not value")
    return out, C


# K6's value mode: name -> options.  dtype: the deltas' type; C; blocks:
# one output row each, an int (a block of that many records: random deltas
# over the type's range, zero past them, as value_batch pads), None (a
# block that lacks the column: zeroed, -1) or "other" (a row another
# launch writes: left alone, -2); p_valid: the share of valid entries;
# wrap: int64 deltas near +-2^62 and bases near +-2^63, so the running sum
# wraps mod 2^64.  A tile of the look-back is 4,096 entries (a row of
# fewer is one tile).
K6V_CASES = {
    "uint8 deltas, C 128": dict(dtype="uint8", C=128, blocks=(100, 128, 1)),
    "uint16 deltas, blocks shorter than C": dict(
        dtype="uint16", C=4096, blocks=(4096, 3000, 17)),
    "int32 deltas, C 65,536": dict(dtype="int32", C=65536,
                                   blocks=(65536, 40000, None, "other")),
    "int8 deltas": dict(dtype="int8", C=8192, blocks=(8192, 5)),
    "int16 deltas, C 16,384": dict(dtype="int16", C=16384,
                                         blocks=(16384, 10000, None)),
    "int64 deltas that wrap": dict(dtype="int64", C=65536,
                                   blocks=(65536, 65536), wrap=True),
    "a block of one record": dict(dtype="int32", C=1024, blocks=(1, 1)),
    "all entries invalid": dict(dtype="int16", C=2048, blocks=(2048, 700),
                                p_valid=0.0),
    "-1 and -2 rows into a poisoned output": dict(
        dtype="uint8", C=32768,
        blocks=(None, "other", 20000, None, "other", 32768)),
    "C 262,144": dict(dtype="int32", C=262144,
                                        blocks=(262144, 100000)),
}


def k6v_case(name: str, seed: int = 0):
    """K6V_CASES[name] as numpy arrays -> (deltas [b, C] of the case's
    type, bits uint8 [b, C/8], bases int64 [b], src_of_row int32 [B], C)."""
    import numpy as np
    o = K6V_CASES[name]
    rng = np.random.default_rng(seed + sorted(K6V_CASES).index(name))
    C = o["C"]
    dt = np.dtype(o["dtype"])
    info = np.iinfo(dt)
    blocks = [n for n in o["blocks"] if isinstance(n, int)]
    deltas = np.zeros((len(blocks), C), dt)
    bits = np.zeros((len(blocks), C // 8), np.uint8)
    for j, n in enumerate(blocks):
        if o.get("wrap"):
            d = rng.integers(2 ** 62 - 2 ** 20, 2 ** 62, n)
            deltas[j, :n] = np.where(rng.random(n) < 0.5, d, -d)
        else:
            deltas[j, :n] = rng.integers(max(info.min, -2 ** 62),
                                         min(info.max, 2 ** 62), n,
                                         endpoint=True)
        m = rng.random(n) < o.get("p_valid", 0.9)
        bits[j, : -(-n // 8)] = np.packbits(m, bitorder="little")
    hi = 2 ** 63 - 1 if o.get("wrap") else 2 ** 40
    bases = rng.integers(-hi, hi, len(blocks), dtype=np.int64)
    src, j = [], 0
    for n in o["blocks"]:
        if n is None:
            src.append(-1)
        elif n == "other":
            src.append(-2)
        else:
            src.append(j)
            j += 1
    return deltas, bits, bases, np.asarray(src, np.int32), C


def k6_edge_checks(card, device, errs) -> None:
    """K6's id mode against its plain version on K6_CASES, through
    decode_column_batch (each encoding's launch writing its own rows),
    and each case's id launch alone on its batch; fails unless the id
    launches took data rows, zeroed rows (-1) and rows of another launch
    (-2)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import decode
    seen = set()
    for name in K6_CASES:
        cs, C = k6_case(name)
        kinds = decode_check(f"id mode: {name}", cs, C, device, errs)
        if "str_value" not in kinds:
            fail(f"K6 case {name}: no str-value block ({kinds})")
        ks, _ = decode.classify_containers(cs, C)
        idx = [i for i, k in enumerate(ks) if k == "str_value"]
        first = [k for k in ("bucket2", "bucket", "value", "str_value")
                 if k in ks][0] == "str_value"
        src = np.full(len(cs), decode.ZERO_ROW if first else
                      decode.OTHER_ROW, dtype=np.int32)
        src[[i for i, k in enumerate(ks) if k != "missing"]] = \
            decode.OTHER_ROW
        src[idx] = np.arange(len(idx), dtype=np.int32)
        seen |= {int(x) for x in src if x < 0} | {0}
        ins = [torch.from_numpy(a).to(device)
               for a in (*decode.ids_batch(cs, idx, C), src)]
        # poisoned outputs: the rows another launch writes must keep it
        got, want = ((torch.full((len(cs), C), FILL, dtype=torch.int64,
                                 device=device),
                      torch.ones((len(cs), C), dtype=torch.bool,
                                 device=device)) for _ in range(2))
        decode.decode_ids(*ins, C, out=got)
        decode.decode_ids_plain(*ins, C, out=want)
        check_equal(f"K6 ids {name} values", got[0], want[0],
                    errs["decode_value"])
        check_equal(f"K6 ids {name} valid", got[1], want[1],
                    errs["decode_value"])
    if seen != {0, decode.ZERO_ROW, decode.OTHER_ROW}:
        fail(f"K6 id cases took row codes {sorted(seen)}, not data, "
             f"{decode.ZERO_ROW} and {decode.OTHER_ROW}")
    say(f"[{card}] K6 id mode == plain (tolerance 0) on {len(K6_CASES)} "
        f"cases ({', '.join(K6_CASES)}): data, zeroed and skipped rows")
    # the value mode on K6V_CASES, each launch into a poisoned output
    seen, dts = set(), set()
    for name in K6V_CASES:
        deltas, bits, bases, src, C = k6v_case(name)
        seen |= {int(x) for x in src if x < 0} | {0}
        dts.add(str(deltas.dtype))
        ins = [torch.from_numpy(a).to(device)
               for a in (deltas, bits, bases, src)]
        got, want = ((torch.full((len(src), C), FILL, dtype=torch.int64,
                                 device=device),
                      torch.ones((len(src), C), dtype=torch.bool,
                                 device=device)) for _ in range(2))
        decode.decode_value(*ins, C, out=got)
        decode.decode_value_plain(*ins, C, out=want)
        check_equal(f"K6 value {name} values", got[0], want[0],
                    errs["decode_value"])
        check_equal(f"K6 value {name} valid", got[1], want[1],
                    errs["decode_value"])
    if seen != {0, decode.ZERO_ROW, decode.OTHER_ROW} or len(dts) != 6:
        fail(f"K6 value cases took row codes {sorted(seen)} and delta "
             f"types {sorted(dts)}, not all three and six")
    deltas, bits, bases, src, C = k6v_case("int32 deltas, C 65,536")
    ins = [torch.from_numpy(a).to(device) for a in (deltas, bits, bases,
                                                     src)]
    LATE_OP_CHECKS.append(("decode_value value mode (int32, C 65,536)", 2,
                           lambda: decode.decode_value(*ins, C)))
    say(f"[{card}] K6 value mode == plain (tolerance 0) on "
        f"{len(K6V_CASES)} cases ({', '.join(K6V_CASES)}): six delta "
        f"types, data, zeroed and skipped rows, 1 to 64 tiles a row")


# ---------------------------------------------------------------------------
# phase 4: K2-K5
# ---------------------------------------------------------------------------

def query_params(groups, aggs, weight="", op="avg", htype="basic",
                 filters=(), time_bucket=0, distincts=()):
    from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
    return QueryParams(groups=tuple(groups),
                       aggs=tuple(AggDef(a, op, htype) for a in aggs),
                       filters=tuple(FilterDef(*f) for f in filters),
                       weight_col=weight, time_bucket=time_bucket,
                       time_col="time" if time_bucket else "",
                       distincts=tuple(distincts))


def dev_bits(bitsets, device):
    """The bind's bitsets as device constants, a uint64 hash array as its
    int64 bits (as the engine uploads it)."""
    import numpy as np

    from sybil_tpu_torch.ops.residency import device_const
    return tuple(device_const(b.view(np.int64) if b.dtype == np.uint64
                              else b, device) for b in bitsets)


def bound_query(table, flags, params):
    """The port's BoundQuery with exact bounds over every block: its
    config, filter constants and regex bitsets, as run_query binds
    them."""
    from sybil_tpu_torch.query.engine import BoundQuery
    table.load_info()
    b = BoundQuery(table, params, dataclasses.replace(flags))
    infos = table.block_infos()
    b.apply_exact_bounds(infos, list(infos))
    return b


def bound_config(table, flags, groups, aggs, weight=""):
    return bound_query(table, flags, query_params(groups, aggs,
                                                  weight)).config


def decoded_cols(table, names, C: int, device):
    """{name: (values, valid)} of every block, decoded by K1."""
    from sybil_tpu_torch import blocks
    from sybil_tpu_torch.ops.decode import decode_column_batch
    dirs = sorted(table.block_infos())
    out = {}
    for name in names:
        typ = table.schema.col_type(name)
        cs = [blocks.open_column(d, typ, name) for d in dirs]
        v, m, _ = decode_column_batch(cs, C, device)
        out[name] = (v, m)
    return out, dirs


def set_masks_check(what, cfg, fv, set_aux, R, errs):
    """K14 once per set filter against its plain version, bit for bit ->
    the kernel's masks (scan.set_filter_masks' list), or None."""
    from sybil_tpu_torch.ops import scan
    masks = scan.set_filter_masks(cfg, fv, set_aux, R)
    for i, f in enumerate(cfg.filters):
        if f.kind != "set":
            continue
        prow, pval, n = set_aux[f.col]
        want = scan.set_match_plain(prow, pval, n, fv, i, R)
        for got_w, want_w, name in zip(masks[i], want, ("has", "hit")):
            check_equal(f"K14 {what} filter {i} {name}", got_w, want_w,
                        errs["set_match"])
    return masks


def scan_check(what, cfg, cols, nrec, errs, fv=None, bits=(), tb=1,
               set_aux=None, forms=None):
    """K14 per set filter, K2 (in each form that applies: windowed and
    global for a windowed rollup, or `forms`), K13 with the device HLL,
    then K4 and K5 per histogram aggregation, then K3, each against its
    plain version on the same inputs; the kernels' buffer against
    scan_packed's.  -> (K2 outputs, main)."""
    import torch

    from sybil_tpu_torch.ops import scan
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    dev = nrec.device
    if fv is None:
        fv = torch.zeros(0, dtype=torch.int64, device=dev)
    sm = set_masks_check(what, cfg, fv, set_aux, R, errs)
    k2p = scan.dense_scan_plain(cfg, cols, nrec, fv, bits, tb, sm)
    if forms is None:
        forms = ["windowed", "global"] if scan.windowed(cfg) else [None]
    for form in forms:
        k2 = scan.dense_scan(cfg, cols, nrec, fv, bits, tb, form=form,
                             set_masks=sm)
        for key in ("sums", "spill", "mins", "maxs", "gid", "mask"):
            if (k2[key] is None) != (k2p[key] is None):
                fail(f"K2 {what} {key}: kernel and plain disagree on "
                     f"presence")
            if k2[key] is not None:
                check_equal(f"K2 {what} {form or ''} {key}", k2[key],
                            k2p[key], errs["dense_scan"])
    hll = None
    if cfg.hll and cfg.distinct_cols:
        hll = scan.hll_registers(cfg, cols, k2["gid"], bits)
        check_equal(f"K13 {what} registers", hll,
                    scan.hll_registers_plain(cfg, cols, k2["gid"], bits),
                    errs["hll_registers"])
    layout = scan.packed_layout(cfg, R)
    shape = (layout["rows"], layout["W"])
    main = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    main_p = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    hists, nouts = [], []
    for ai in scan.hist_aggs(cfg):
        h = scan.dense_hist(cfg, ai, cols, k2["gid"])
        hp = scan.dense_hist_plain(cfg, ai, cols, k2["gid"])
        for key in ("hist", "out_mask", "out_val", "nout"):
            if h[key] is not None:
                check_equal(f"K4 {what} agg{ai} {key}", h[key], hp[key],
                            errs["dense_hist"])
        hists.append(h["hist"])
        nouts.append(h["nout"])
        if cfg.track_outliers:
            off, kmax = layout[f"out{ai}"]
            scan.outlier_compact(cfg, cols, h["out_mask"], h["out_val"],
                                 main, off, tb)
            scan.outlier_compact_plain(cfg, cols, h["out_mask"],
                                       h["out_val"], main_p, off, tb)
            check_equal(f"K5 {what} agg{ai} rows", main[off: off + kmax],
                        main_p[off: off + kmax], errs["outlier_compact"])
    scan.dense_pack(cfg, k2, hists, nouts, main, R, hll)
    scan.dense_pack_plain(cfg, k2, hists, nouts, main_p, R, hll)
    check_equal(f"K3 {what} main", main, main_p, errs["dense_pack"])
    packed, raw = scan.scan_packed(cfg, cols, nrec, fv, bits, tb, set_aux)
    if not torch.equal(packed["main"], main):
        fail(f"{what}: scan_packed's buffer differs from the kernels' own")
    if cfg.want_matched_mask and not torch.equal(raw["matched"],
                                                 k2["mask"]):
        fail(f"{what}: scan_packed's matched mask differs from K2's own")
    if hll is not None and not torch.equal(raw["hll_regs"], hll):
        fail(f"{what}: scan_packed's registers differ from K13's own")
    return k2, main


EDGE_SCANS = {
    # name: (group key bounds, n aggs, weight, vbias, i32, extra)
    "no groups": ([], 1, False, False, False, {}),
    "MISSING keys, invalid values": ([(0, 5)], 2, False, False, False, {}),
    "invalid and zero weights": ([(0, 5)], 2, True, False, False, {}),
    "negative int keys": ([(-4, 6), (0, 2), (-1, 3)], 2, False, True,
                          False, {}),
    "three keys, weight, vbias, i32": ([(0, 5), (0, 3), (10, 6)], 3, True,
                                       True, True, {}),
    "near 8192 slots": ([(0, 90), (0, 89)], 1, True, False, False, {}),
    "g+1 == slots (not compact)": ([(0, 126)], 2, False, True, True, {}),
    "spill": ([(0, 3), (0, 4)], 1, False, False, False, {"spill": True}),
    "partial blocks": ([(0, 5)], 2, True, False, False, {"partial": True}),
    "lanes equal to samples skipped": ([(0, 5)], 2, False, True, True,
                                       {"nrows": True}),
    # histogram and filter edges: "hist" lists the aggs' layouts
    # ((hist_min, bucket_size, nv, discard_min, discard_max), "multi" or
    # None for avg), "filters" (col, op, kind, constant)
    "int gt and lt filters": ([(0, 5)], 1, False, False, False,
                              {"hist": [(0, 10, 20, 0, 400)],
                               "filters": [("fi", "gt", "int", 10),
                                           ("fi", "lt", "int", 70)]}),
    "int eq, str neq filters": ([(0, 5)], 1, False, False, False,
                                {"hist": [(0, 10, 20, 0, 400)],
                                 "filters": [("fi", "eq", "int", 7),
                                             ("fs", "neq", "str", 4)]}),
    "int neq, str eq filters": ([(0, 5)], 1, True, False, False,
                                {"hist": [(0, 10, 20, 0, 400)],
                                 "filters": [("fi", "neq", "int", 7),
                                             ("fs", "eq", "str", 4)]}),
    "never-ingested str eq": ([(0, 5)], 1, False, False, False,
                              {"hist": [(0, 10, 20, 0, 400)],
                               "filters": [("fs", "eq", "str", -1)]}),
    "never-ingested str neq": ([(0, 5)], 1, False, False, False,
                               {"hist": [(0, 10, 20, 0, 400)],
                                "filters": [("fs", "neq", "str", -1)]}),
    "regex re and nre": ([(0, 5)], 2, False, False, False,
                         {"hist": [(0, 10, 20, 0, 400), None],
                          "filters": [("fs", "re", "str", 0),
                                      ("fs", "nre", "str", 1)]}),
    "unknown filter op": ([(0, 5)], 1, False, False, False,
                          {"hist": [(0, 10, 20, 0, 400)],
                           "filters": [("fi", "in", "int", 3)]}),
    "weighted hist, negative values": ([(0, 5), (0, 3)], 1, True, False,
                                       False,
                                       {"hist": [(0, 7, 30, -150, 400)]}),
    "multihist sub-outliers": ([(0, 5)], 2, True, False, False,
                               {"hist": ["multi", (0, 10, 20, 0, 400)]}),
    "outliers beyond the packed rows": ([(0, 5)], 1, False, False, False,
                                        {"hist": [(0, 10, 20, 0, 400)],
                                         "max_out": 16}),
    "hist table in global memory": ([(0, 90), (0, 89)], 1, True, False,
                                    False,
                                    {"hist": [(0, 40, 12, 0, 400)],
                                     "hist_prefix": 8}),
    "hist, no groups": ([], 1, True, False, False,
                        {"hist": [(0, 10, 20, 0, 400)]}),
    "hist, not compact": ([(0, 126)], 1, False, False, False,
                          {"hist": [(0, 10, 20, 0, 400)]}),
    # time rollups: "time" = (lo, hi, bucket, time_i32, window, sorted,
    # share of rows with the time column, spill margin); the time key's
    # bound is the data's quotient range, cut by the margin on each side
    "time: negative times, windowed": ([(0, 9)], 1, True, False, False,
                                       {"time": (-3_000_000, 3_000_000,
                                                 3600, True, 128, True, 0.97,
                                                 0)}),
    "time: beyond 2^31, int64 division": ([(0, 9)], 1, False, False, False,
                                          {"time": (1 << 31, (1 << 31)
                                                    + 2_400_000, 3600, False,
                                                    0, False, 1.0, 0)}),
    "time: int64, negative, windowed": ([(0, 5)], 2, True, False, False,
                                        {"time": (-(1 << 40), 1 << 40,
                                                  1 << 33, False, 128, True,
                                                  0.97, 0)}),
    "time: spilled quotient": ([(0, 9)], 1, False, False, False,
                               {"time": (0, 2_400_000, 3600, True, 0, False,
                                         1.0, 20)}),
    "time: spilled quotient, windowed": ([(0, 9)], 1, False, False, False,
                                         {"time": (0, 2_400_000, 3600, True,
                                                   128, True, 1.0, 20)}),
    "time: rows without the time column": ([(0, 9)], 1, True, False, False,
                                           {"time": (0, 2_400_000, 3600,
                                                     True, 128, True, 0.5,
                                                     0)}),
    "time: span wider than 8 bands": ([(0, 9)], 1, True, False, False,
                                      {"time": (0, 2_400_000, 3600, True,
                                                128, False, 0.97, 0)}),
    "time: hist, tracked outliers": ([(0, 9)], 1, True, False, False,
                                     {"hist": [(0, 10, 20, 0, 400)],
                                      "time": (-1_000_000, 1_400_000, 3600,
                                               True, 256, True, 0.97, 0)}),
}
MULTI_EDGES = ((200, 300, 8, 20, 0), (100, 199, 4, 20, 20),
               (0, 99, 3, 30, 40))   # top range first; 70 buckets


def edge_scan(name: str, device, B: int = 3, C: int = 65536):
    """A synthetic dense-scan batch -> (ScanConfig, cols, nrec,
    filter_vals, bitsets, time bucket)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.scan import (AggSpec, FilterSpec, ScanConfig,
                                          windowed)
    bounds, A, weight, vbias, i32, extra = EDGE_SCANS[name]
    rng = np.random.default_rng(len(name))
    R = B * C
    cols, groups, aggs = {}, [], []

    def put(col, v, m):
        cols[col] = (torch.from_numpy(v.reshape(B, C)).to(device),
                     torch.from_numpy(m.reshape(B, C)).to(device))

    for i, (mn, card) in enumerate(bounds):
        hi = card + 1 if extra.get("spill") else card
        put(f"k{i}", rng.integers(mn, mn + hi, R).astype(np.int64),
            rng.random(R) < 0.9)
        groups.append(f"k{i}")
    hist = extra.get("hist", [None] * A)
    for a in range(A):
        lo, hi = -50 * a, 200 + 100 * a
        m = (np.ones(R, bool) if extra.get("nrows")
             else rng.random(R) < 0.85)
        if hist[a] is None:
            put(f"v{a}", rng.integers(lo - 20, hi + 40, R).astype(np.int64),
                m)
            aggs.append(AggSpec(f"v{a}", hist_min=lo, bucket_size=0,
                                num_values=0, discard_min=lo,
                                discard_max=hi))
            continue
        put(f"v{a}", rng.integers(-200, 700, R).astype(np.int64), m)
        if hist[a] == "multi":
            aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                num_values=70, discard_min=0,
                                discard_max=650, sub_edges=MULTI_EDGES))
        else:
            hmin, bs, nv, dmin, dmax = hist[a]
            aggs.append(AggSpec(f"v{a}", hist_min=hmin, bucket_size=bs,
                                num_values=nv, discard_min=dmin,
                                discard_max=dmax))
    filters, fvals = [], []
    if "filters" in extra:
        put("fi", rng.integers(0, 80, R).astype(np.int64),
            rng.random(R) < 0.9)
        put("fs", rng.integers(0, 10, R).astype(np.int64),
            rng.random(R) < 0.9)
        for col, op, kind, val in extra["filters"]:
            filters.append(FilterSpec(col, op, kind,
                                      {"re": 0, "nre": 1}.get(op, -1)))
            fvals.append(val)
    bits = tuple(torch.from_numpy(np.array([i % k == 0 for i in range(10)]))
                 .to(device) for k in (3, 4))
    wmax = 1
    if weight:
        put("w", rng.integers(0, 101, R).astype(np.int64),
            rng.random(R) < 0.8)
        wmax = 100
    rb, nrows = (), ()
    if i32:
        rb = [wmax, 1]
        for a in aggs:
            rb += [1, wmax, wmax * (a.discard_max - a.discard_min)]
    if extra.get("nrows"):
        nrows = [not weight, True]
        for _ in aggs:
            nrows += [True, not weight, False]
    tb, tkw = 1, {}
    if "time" in extra:
        lo, hi, tb, i32, window, sort, tvalid, margin = extra["time"]
        t = rng.integers(lo, hi, R)
        if sort:
            t = np.sort(t)
        put("t", t, rng.random(R) < tvalid)
        q = np.where(t >= 0, t // tb, -((-t) // tb))
        qmin, card = int(q.min()) + margin, int(q.max() - q.min()) + 1
        bounds = [(qmin, card - 2 * margin)] + bounds
        tkw = dict(time_col="t", time_i32=i32, window=window,
                   window_chunk=8192 if window else 0)
    cfg = ScanConfig(group_cols=tuple(groups), aggs=tuple(aggs),
                     filters=tuple(filters),
                     weight_col="w" if weight else "",
                     key_bounds=tuple(bounds), **tkw,
                     agg_vbias=(tuple(a.discard_min for a in aggs)
                                if vbias else ()),
                     lane_row_bounds=tuple(rb), lane_nrows=tuple(nrows),
                     track_outliers="hist" in extra,
                     max_out=extra.get("max_out", 1024),
                     hist_prefix=extra.get("hist_prefix", 128))
    nrec = np.full(B, C, dtype=np.int32)
    if extra.get("partial"):
        nrec[:] = [0, 700, 1]
    fv = torch.tensor(fvals, dtype=torch.int64, device=device)
    if "time" in extra and (cfg.window > 0) != windowed(cfg):
        fail(f"edge scan {name}: window {cfg.window} of "
             f"{cfg.dense_slots} slots")
    return cfg, cols, torch.from_numpy(nrec).to(device), fv, bits, tb


# ---------------------------------------------------------------------------
# phase 4: the sorted strategy (K7-K10, sort_permute, K5 over kmat)
# ---------------------------------------------------------------------------

def check_outs(kernel, what, got: dict, want: dict, keys, errs):
    """Each named output of a kernel against its plain version."""
    for key in keys:
        if (got[key] is None) != (want[key] is None):
            fail(f"{kernel} {what} {key}: kernel and plain disagree on "
                 f"presence")
        if got[key] is not None:
            check_equal(f"{kernel} {what} {key}", got[key], want[key],
                        errs[kernel])


PREP_OUTS = ("pairkey", "w", "out_mask", "out_val", "nout")


def check_pairs(what, got: dict, want: dict, errs) -> None:
    """K9's hist_pairs against its plain version: hp_mask and npairs
    whole, hp_bv, hp_w and hp_keys at the rows hp_mask sets and at row
    R-1, the rows the kernel writes and its readers read (the plain
    version fills every row)."""
    import torch
    check_outs("hist_pairs", what, got, want, ("hp_mask", "npairs"), errs)
    mask = want["hp_mask"]
    R = mask.numel()
    rows = torch.cat([torch.nonzero(mask[:R - 1]).reshape(-1),
                      torch.tensor([R - 1], device=mask.device)])
    for key in ("hp_bv", "hp_w", "hp_keys"):
        check_equal(f"hist_pairs {what} {key} at {rows.numel() - 1} set "
                    f"rows before R-1 and row R-1", got[key][rows],
                    want[key][rows], errs["hist_pairs"])


K8_OUTS = ("sums", "mins", "maxs", "keys", "kmat", "sidxm", "gid",
           "num_groups", "dmat", "pair_mask")
K8_PATHS = {}                   # device -> the path counts of K8's checks
K9_PATHS = {}                   # the same of K9's hist_pairs


def k9_paths(device):
    """The int64 counts every checked hist_pairs launch on `device` adds
    its paths to (scan.K9_PATHS)."""
    import torch

    from sybil_tpu_torch.ops import scan
    # "cuda" and "cuda:0" are one card
    key = torch.empty(0, device=device).device
    if key not in K9_PATHS:
        K9_PATHS[key] = torch.zeros(len(scan.K9_PATHS), dtype=torch.int64,
                                    device=key)
    return K9_PATHS[key]


def k8_paths(device):
    """The int64 counts every checked K8 launch on `device` adds its
    paths to (scan.SEGMENT_PATHS)."""
    import torch

    from sybil_tpu_torch.ops import scan
    if device not in K8_PATHS:
        K8_PATHS[device] = torch.zeros(len(scan.SEGMENT_PATHS),
                                       dtype=torch.int64, device=device)
    return K8_PATHS[device]


def sorted_check(what, cfg, cols, nrec, errs, fv=None, bits=(), tb=1,
                 set_aux=None):
    """K14 per set filter, K7, the sorts (sort_permute between them), K8,
    K9's two entries, K5 over kmat and K10, each kernel against its plain
    version on the same inputs, word for word; the kernels' buffers
    against scan_packed's.  -> (main, table, {"front", "order", "k8",
    "preps", "pairs"})."""
    import torch

    from sybil_tpu_torch.ops import scan
    if cfg.strategy != "sorted":
        fail(f"{what}: strategy {cfg.strategy}, not sorted")
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    dev = nrec.device
    if fv is None:
        fv = torch.zeros(0, dtype=torch.int64, device=dev)
    sm = set_masks_check(what, cfg, fv, set_aux, R, errs)
    front = scan.sorted_front(cfg, cols, nrec, fv, bits, tb, sm)
    check_outs("sorted_front", what, front, scan.sorted_front_plain(
        cfg, cols, nrec, fv, bits, tb, sm), ("key", "keys", "idxm", "spill",
                                             "totals", "mask"), errs)
    if front["key"] is not None:
        skey, p = torch.sort(front["key"], stable=True)
        order = {"skey": skey, "p": p, "base": None, "svals": None}
    else:
        keys = front["keys"]
        svals, p = torch.sort(keys[-1], stable=True)
        base = None
        for k in range(keys.shape[0] - 2, -1, -1):
            nb, g = scan.sort_permute(base, p, keys[k])
            nbp, gp = scan.sort_permute_plain(base, p, keys[k])
            check_equal(f"sort_permute {what} perm", nb, nbp,
                        errs["sort_permute"])
            check_equal(f"sort_permute {what} key {k}", g, gp,
                        errs["sort_permute"])
            base = nb
            svals, p = torch.sort(g, stable=True)
        order = {"skey": None, "p": p, "base": base, "svals": svals}
    rows_order = scan.sort_rows(cfg, front)
    for key in ("p", "base", "svals"):
        if (rows_order[key] is None) != (order[key] is None) or (
                order[key] is not None
                and not torch.equal(rows_order[key], order[key])):
            fail(f"{what}: sort_rows gives another {key}")
    S = cfg.max_groups
    k8 = scan.segment_reduce(cfg, cols, front, order, tb, paths=k8_paths(dev))
    check_outs("segment_reduce", what, k8, scan.segment_reduce_plain(
        cfg, cols, front, order, tb), K8_OUTS, errs)
    layout = scan.packed_layout(cfg, R)
    shape = (layout["rows"], layout["W"])
    main = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    main_p = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    preps, pairs, nouts = [], [], []
    for ai in scan.hist_aggs(cfg):
        prep = scan.hist_prep(cfg, ai, cols, k8)
        check_outs("hist_prep", f"{what} agg{ai}", prep,
                   scan.hist_prep_plain(cfg, ai, cols, k8), PREP_OUTS, errs)
        spk, si2 = torch.sort(prep["pairkey"], stable=True)
        hp = scan.hist_pairs(cfg, ai, spk, si2, prep["w"], k8["kmat"],
                             paths=k9_paths(dev))
        check_pairs(f"{what} agg{ai}", hp, scan.hist_pairs_plain(
            cfg, ai, spk, si2, prep["w"], k8["kmat"]), errs)
        preps.append(prep)
        pairs.append(hp)
        nouts.append(prep["nout"])
        if cfg.track_outliers:
            off, kmax = layout[f"out{ai}"]
            scan.outlier_compact(cfg, cols, prep["out_mask"],
                                 prep["out_val"], main, off, tb,
                                 kmat=k8["kmat"])
            scan.outlier_compact_plain(cfg, cols, prep["out_mask"],
                                       prep["out_val"], main_p, off, tb,
                                       kmat=k8["kmat"])
            check_equal(f"K5 {what} agg{ai} rows (kmat keys)",
                        main[off: off + kmax], main_p[off: off + kmax],
                        errs["outlier_compact"])
    k10 = scan.sorted_pack(cfg, k8, front["spill"], pairs, nouts, main, R)
    k10p = scan.sorted_pack_plain(cfg, k8, front["spill"], pairs, nouts,
                                  main_p, R)
    check_outs("sorted_pack", what, k10, k10p, ("table", "score"), errs)
    table = k10["table"]
    if k10["score"] is not None:
        # the device prune: K12 over the slots' scores, then the gather,
        # in one call
        P = scan.table_prefix(cfg)
        pidx, table = scan.prune_topk_gather(cfg, k10["score"], table, main)
        want_pidx = scan.topk_rows_plain(k10["score"], P)
        check_equal(f"topk_rows {what} (prune, {k10['score'].dtype} [{S}])",
                    pidx, want_pidx, errs["topk_rows"])
        check_equal(f"prune_gather {what} table", table,
                    scan.prune_gather_plain(cfg, k10p["table"], want_pidx,
                                            main_p), errs["prune_gather"])
    check_equal(f"sorted_pack {what} main", main, main_p,
                errs["sorted_pack"])
    packed, raw = scan.scan_packed(cfg, cols, nrec, fv, bits, tb, set_aux)
    if not (torch.equal(packed["main"], main)
            and torch.equal(packed["table"], table)):
        fail(f"{what}: scan_packed's buffers differ from the kernels' own")
    if cfg.want_matched_mask and not torch.equal(raw["matched"],
                                                 front["mask"]):
        fail(f"{what}: scan_packed's matched mask differs from K7's own")
    return main, table, {"front": front, "order": order, "k8": k8,
                         "preps": preps, "pairs": pairs}


# name -> options.  keys: [(lo, hi) of the values, pack bound (min, card)
# or None]; time: (lo, hi, bucket, time_i32); hist: per aggregation
# "basic" | "multi" | "identity" (value-identity buckets, as -tdigest
# binds them, here narrower than the values so outliers are live) | None;
# filters: (col, op, kind, constant); extra: ScanConfig fields
SORTED_EDGES = {
    "packed key past 2^31 (int64)": dict(
        keys=[((0, 60000), (0, 60000)), ((0, 50000), (0, 50000))],
        hist=[None]),
    "packed spill": dict(keys=[((0, 12), (0, 9)), ((0, 4), (0, 4))],
                         hist=["basic"], track=True),
    # values of min - 1 pack as digit 0, as MISSING does: K8 reads them
    "packed key, values at min - 1": dict(
        keys=[((4, 14), (5, 9)), ((0, 3), (0, 3))], hist=[None]),
    "three unpacked int keys, MISSING and negative values": dict(
        keys=[((-5, 4), None), ((-3, 3), None), ((-1000, 1000), None)],
        hist=[None, None]),
    "time key, int64 division": dict(
        keys=[((0, 5), None)],
        time=((1 << 33) - 5_000_000, (1 << 33) + 5_000_000, 7, False),
        hist=["basic"], track=True),
    "time key, int32 division": dict(
        keys=[((0, 9), None)], time=(-400_000, 900_000, 100, True),
        hist=[None]),
    "weighted rows, filters": dict(
        keys=[((0, 9), (0, 9))], hist=["basic", None], weight=True,
        track=True, filters=[("fi", "gt", "int", 10),
                             ("fs", "neq", "str", 4),
                             ("fs", "re", "str", 0)]),
    "multihist, live outliers": dict(keys=[((0, 6), (0, 6))],
                                     hist=["multi"], weight=True, track=True),
    "value-identity buckets, live outliers": dict(
        keys=[((0, 4), (0, 4))], hist=["identity"], track=True),
    "groups past prefix_rows": dict(keys=[((0, 20000), None)], hist=[None]),
    "hist pairs past Hcap": dict(keys=[((0, 3000), None)], hist=["basic"],
                                 weight=True),
    "group cap: max_groups 1000 under 5000 groups": dict(
        keys=[((0, 5000), None)], hist=["basic"],
        extra=dict(max_groups=1000)),
    "no group keys, value bias": dict(keys=[], hist=[None, "basic"],
                                      vbias=True),
}


def sorted_edge(name: str, device, B: int = 3, C: int = 65536):
    """A synthetic sorted-strategy batch -> (ScanConfig, cols, nrec,
    filter_vals, bitsets, time bucket)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.scan import AggSpec, FilterSpec, ScanConfig
    o = SORTED_EDGES[name]
    rng = np.random.default_rng(len(name) + 100)
    R = B * C
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C))
                     .to(device),
                     torch.from_numpy((rng.random(R) < p_valid)
                                      .reshape(B, C)).to(device))

    groups, pack = [], []
    for i, ((lo, hi), pb) in enumerate(o["keys"]):
        put(f"k{i}", rng.integers(lo, hi, R), 0.9)
        groups.append(f"k{i}")
        pack.append(pb)
    tkw, tb = {}, 1
    if "time" in o:
        lo, hi, tb, i32 = o["time"]
        put("t", rng.integers(lo, hi, R), 0.95)
        tkw = dict(time_col="t", time_i32=i32)
        pack = []
    aggs = []
    for a, h in enumerate(o["hist"]):
        put(f"v{a}", np.where(rng.random(R) < 0.03,
                              rng.integers(500, 3000, R),
                              rng.integers(-20, 400, R)), 0.85)
        if h is None:
            aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                num_values=0, discard_min=-10,
                                discard_max=2500))
        elif h == "multi":
            aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=0,
                                num_values=70, discard_min=0,
                                discard_max=2500, sub_edges=MULTI_EDGES))
        elif h == "identity":
            aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=1,
                                num_values=402, discard_min=0,
                                discard_max=2500))
        else:
            aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=10,
                                num_values=40, discard_min=0,
                                discard_max=2500))
    filters, fvals = [], []
    if o.get("filters"):
        put("fi", rng.integers(0, 80, R), 0.9)
        put("fs", rng.integers(0, 10, R), 0.9)
        for col, op, kind, val in o["filters"]:
            filters.append(FilterSpec(col, op, kind,
                                      0 if op in ("re", "nre") else -1))
            fvals.append(val)
    bits = (torch.from_numpy(np.array([i % 3 == 0 for i in range(10)]))
            .to(device),)
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    cfg = ScanConfig(
        group_cols=tuple(groups), aggs=tuple(aggs), filters=tuple(filters),
        weight_col="w" if o.get("weight") else "", force_sorted=True,
        sort_pack=(tuple(pack) if pack and all(p is not None for p in pack)
                   else ()),
        track_outliers=bool(o.get("track")),
        agg_vbias=(tuple(a.discard_min for a in aggs) if o.get("vbias")
                   else ()), **tkw, **o.get("extra", {}))
    nrec = torch.tensor([C, 700, C - 3], dtype=torch.int32, device=device)
    return (cfg, cols, nrec, torch.tensor(fvals, dtype=torch.int64,
                                          device=device), bits, tb)


# K8's own cases: name -> options.  B, C: the batch; keys: per group key
# ((lo, hi) of the values, pack bound (min, card) or None), or a layout
# name: "unique" (every row its own key), "edges" (a group key and one
# distinct lane whose sorted runs start on edges of K8's 1,024-row
# tiles: 2,048 rows of each of (0, 0), (0, 1), (1, 0), then (1, 1));
# key_valid: the share of valid key values (0.9); distinct: the distinct
# lanes' (lo, hi); hist: per aggregation "basic" | None; weight, filters,
# partial (nrec below C in the middle block), time (lo, hi, bucket,
# time_i32), cg (the cache-group key ahead of the keys, this many blocks
# a group), extra: ScanConfig fields
K8_CASES = {
    "segments across tile and warp edges": dict(
        B=3, C=4096, keys=[((0, 50), None)], hist=[None, "basic"],
        weight=True),
    "one segment across several tiles": dict(
        B=4, C=8192, keys=[((0, 2), None)], hist=["basic"]),
    "one group": dict(B=2, C=4096, keys=[((7, 8), None)], key_valid=1.0,
                      hist=[None]),
    "every row its own group": dict(B=3, C=4096, keys="unique",
                                    hist=[None]),
    "R not a multiple of the tile": dict(B=3, C=512, keys=[((0, 30), None)],
                                         hist=["basic"], partial=True),
    "R below one tile": dict(B=1, C=512, keys=[((0, 30), None)],
                             hist=[None]),
    "R of 12 rows: a thread's rows cut short": dict(
        B=3, C=4, keys=[((0, 3), None)], hist=[None]),
    "groups past S": dict(B=2, C=4096, keys=[((0, 400), None)],
                          hist=["basic"], extra=dict(max_groups=50)),
    "unmatched and spilled rows under the sentinel": dict(
        B=3, C=4096, keys=[((0, 12), (0, 9)), ((0, 4), (0, 4))],
        hist=["basic"], partial=True,
        filters=[("fi", "gt", "int", 10)]),
    "packed int32 key": dict(B=3, C=4096,
                             keys=[((0, 9), (0, 9)), ((0, 7), (0, 7))],
                             hist=[None], weight=True),
    "packed int64 key": dict(B=2, C=4096,
                             keys=[((0, 60000), (0, 60000)),
                                   ((0, 50000), (0, 50000))], hist=[None]),
    "packed key, values at min - 1": dict(
        B=2, C=4096, keys=[((4, 14), (5, 9)), ((0, 3), (0, 3))],
        hist=[None]),
    "unpacked keys, MISSING and negative values": dict(
        B=3, C=4096, keys=[((-5, 4), None), ((-3, 3), None),
                           ((-1000, 1000), None)], hist=[None, "basic"]),
    "pair and group starts on tile edges": dict(
        B=2, C=4096, keys="edges", hist=[]),
    "distinct pairs over two lanes": dict(
        B=3, C=4096, keys=[((0, 5), None)], distinct=[(0, 3), (-5, 200)],
        hist=[], partial=True),
    "the cache-group key": dict(B=8, C=1024, keys=[((0, 6), None)],
                                hist=["basic"], cg=2),
    "time key": dict(B=3, C=4096, keys=[((0, 9), None)],
                     time=(-400_000, 900_000, 100, True), hist=[None]),
    "17 keys and 33 aggregations": dict(
        B=2, C=1024, keys=[((0, 2), None)] * 17,
        hist=["basic"] + [None] * 32, weight=True),
}


def k8_case(name: str, seed: int = 0):
    """K8_CASES[name] -> (ScanConfig fields with aggs and filters as field
    dicts, {col: (values int64 [B, C], valid bool [B, C])}, nrec int32
    [B], filter constants int64 [F], regex bitsets, time bucket), all
    numpy, made from the seed."""
    return sorted_case(K8_CASES[name],
                       seed + 500 + sorted(K8_CASES).index(name))[:6]


def sorted_case(o: dict, seed: int):
    """A sorted-strategy batch from K8_CASES' or K7_CASES' options ->
    (ScanConfig fields with aggs and filters as field dicts, {col: (values
    int64 [B, C], valid bool [B, C])}, nrec int32 [B], filter constants
    int64 [F], regex bitsets, time bucket, {set column: (row ids int32
    [M], values int64 [M])}), all numpy, made from the seed."""
    import numpy as np
    B, C = o["B"], o["C"]
    R = B * C
    rng = np.random.default_rng(seed)
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     (rng.random(R) < p_valid).reshape(B, C))

    groups, pack, distinct = [], [], []
    if o["keys"] == "unique":
        put("k0", rng.permutation(R), 1.0)
        groups, pack = ["k0"], [None]
    elif o["keys"] == "edges":
        pair = np.repeat(np.arange(4), [2048, 2048, 2048, R - 6144])
        perm = rng.permutation(R)
        k, d = np.empty(R, np.int64), np.empty(R, np.int64)
        k[perm], d[perm] = pair // 2, pair % 2
        put("k0", k, 1.0)
        put("d0", d, 1.0)
        groups, pack, distinct = ["k0"], [None], ["d0"]
    else:
        for i, ((lo, hi), pb) in enumerate(o["keys"]):
            put(f"k{i}", rng.integers(lo, hi, R), o.get("key_valid", 0.9))
            groups.append(f"k{i}")
            pack.append(pb)
    for i, (lo, hi) in enumerate(o.get("distinct", ())):
        put(f"d{i}", rng.integers(lo, hi, R), 0.9)
        distinct.append(f"d{i}")
    # lead_pack: the (min, card) bounds of the cache-group and time lanes,
    # which then join the packed key
    lead = o.get("lead_pack")
    tkw, tb = {}, 1
    if "time" in o:
        lo, hi, tb, i32 = o["time"]
        put("t", rng.integers(lo, hi, R), 0.95)
        tkw = dict(time_col="t", time_i32=i32)
        pack = pack if lead else []
    if o.get("cg"):
        groups = ["__cg__"] + groups
        tkw["vg_span"] = o["cg"]
        pack = pack if lead else []
    pack = (lead or []) + pack
    aggs = []
    for a, h in enumerate(o["hist"]):
        put(f"v{a}", np.where(rng.random(R) < 0.03,
                              rng.integers(500, 3000, R),
                              rng.integers(-20, 400, R)), 0.85)
        aggs.append(dict(col=f"v{a}", hist_min=0, bucket_size=0,
                         num_values=0, discard_min=-10, discard_max=2500)
                    if h is None else
                    dict(col=f"v{a}", hist_min=0, bucket_size=10,
                         num_values=40, discard_min=0, discard_max=2500))
    # filters: (col, op, kind, constant); a column's values are drawn
    # from fcols[col] (default [0, 80)) at 90% valid, a set column's rows
    # hold 0-3 values of [0, 5)
    filters, fvals, sets = [], [], {}
    for col, op, kind, val in o.get("filters", ()):
        if kind == "set":
            if col not in sets:
                rows = np.repeat(np.arange(R, dtype=np.int32),
                                 rng.integers(0, 4, R))
                sets[col] = (rows, rng.integers(0, 5, len(rows)))
        else:
            lo, hi = o.get("fcols", {}).get(col, (0, 80))
            put(col, rng.integers(lo, hi, R), 0.9)
        filters.append(dict(col=col, op=op, kind=kind,
                            bitset_idx=0 if op in ("re", "nre") else -1))
        fvals.append(val)
    if o.get("weight") == "wrap":
        put("w", rng.integers(-2 ** 62, 2 ** 62, R), 0.8)
    elif o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    fields = dict(group_cols=tuple(groups), aggs=tuple(aggs),
                  filters=tuple(filters), distinct_cols=tuple(distinct),
                  weight_col="w" if o.get("weight") else "",
                  force_sorted=True, track_outliers=any(o["hist"]),
                  want_matched_mask=bool(o.get("mask")),
                  sort_pack=(tuple(pack) if pack and not distinct and
                             all(p is not None for p in pack) else ()),
                  **tkw, **o.get("extra", {}))
    nrec = np.full(B, C, dtype=np.int32)
    if o.get("partial"):
        nrec[B // 2] = C // 3
    return (fields, cols, nrec, np.asarray(fvals, np.int64),
            (np.array([i % 3 == 0 for i in range(10)]),), tb, sets)


def k8_edge_checks(card, device, errs) -> None:
    """K8 against its plain version on K8_CASES; then fails unless K8's
    checks so far (these and sorted_check's, the main path's shapes among
    them) took a look-back past one tile, a segment cut by a tile edge
    and a run carried from lane to lane."""
    import torch

    from sybil_tpu_torch.ops import scan
    for name in K8_CASES:
        fields, cols, nrec, fv, bits, tb = k8_case(name)
        cfg = scan.config_from_fields(fields)
        tc = {k: (torch.from_numpy(v).to(device),
                  torch.from_numpy(m).to(device))
              for k, (v, m) in cols.items()}
        front = scan.sorted_front(
            cfg, tc, torch.from_numpy(nrec).to(device),
            torch.from_numpy(fv).to(device),
            tuple(torch.from_numpy(b).to(device) for b in bits), tb)
        order = scan.sort_rows(cfg, front)
        check_outs("segment_reduce", f"case {name}",
                   scan.segment_reduce(cfg, tc, front, order, tb,
                                       paths=k8_paths(device)),
                   scan.segment_reduce_plain(cfg, tc, front, order, tb),
                   K8_OUTS, errs)
    n = dict(zip(scan.SEGMENT_PATHS, k8_paths(device).tolist()))
    for label in ("look-back past one tile", "cut segment", "carried run"):
        if not n[label]:
            fail(f"K8's checks never took the path {label!r}: {n}")
    say(f"[{card}] K8 segment_reduce == plain (tolerance 0) on "
        f"{len(K8_CASES)} cases ({', '.join(K8_CASES)}); paths over every "
        f"checked launch: {n}")


# K7's and sort_permute's own cases (tests/test_torch_sorted.py holds the
# plain versions to the reference's _front_end, the packed key of
# _scan_sorted and _scan_enum and lax.sort's order on the same batches;
# the card holds the kernels to the plain versions): name -> sorted_case
# options (K8_CASES' and fcols: a filter column's value range; weight
# "wrap": weights of +-2^62; mask: the matched mask; lead_pack: the
# cache-group and time lanes' packed bounds).  The filter "zz" is
# an unknown op; 17 filters put constants past the 16 K7 stages in shared
# memory; 17 keys with 40 or 48 filters put the descriptor block past
# its 256-word head.
K7_CASES = {
    "packed int32 key": dict(
        B=3, C=4096, keys=[((0, 9), (0, 9)), ((0, 7), (0, 7))], hist=[],
        filters=[("fi", "gt", "int", 10)]),
    "packed int64 key": dict(
        B=2, C=4096, keys=[((0, 60000), (0, 60000)),
                           ((0, 50000), (0, 50000))], hist=[]),
    "packed spill": dict(B=3, C=4096, keys=[((0, 12), (0, 9)),
                                            ((0, 4), (0, 4))], hist=[],
                         partial=True),
    "packed key, values at min - 1": dict(
        B=2, C=4096, keys=[((4, 14), (5, 9)), ((0, 3), (0, 3))], hist=[]),
    "unpacked keys, MISSING and negative values": dict(
        B=3, C=4096, keys=[((-5, 4), None), ((-3, 3), None),
                           ((-1000, 1000), None)], hist=[]),
    "time key, int32 arithmetic, negative times": dict(
        B=3, C=4096, keys=[((0, 9), None)],
        time=(-400_000, 900_000, 100, True), hist=[]),
    "time key, int64 arithmetic, negative times": dict(
        B=3, C=4096, keys=[((0, 5), None)],
        time=(-(1 << 40), 1 << 40, 7, False), hist=[]),
    "distinct lanes (K + D = 3)": dict(
        B=3, C=4096, keys=[((0, 5), None)], distinct=[(0, 3), (-5, 200)],
        hist=[], partial=True),
    "the cache-group lane": dict(B=8, C=1024, keys=[((0, 6), None)],
                                 hist=[], cg=2),
    "the cache-group lane under a time key": dict(
        B=8, C=1024, keys=[((0, 6), None)], hist=[], cg=4,
        time=(-50_000, 50_000, 1000, True)),
    "int and str filters (gt, lt, eq, neq)": dict(
        B=3, C=4096, keys=[((0, 5), (0, 5))], hist=[],
        filters=[("fi", "gt", "int", 10), ("fj", "lt", "int", 70),
                 ("fe", "eq", "str", 1), ("fs", "neq", "str", 4)],
        fcols={"fe": (0, 2), "fs": (0, 10)}),
    "regex and set filters (re, nre, in, nin)": dict(
        B=3, C=4096, keys=[((0, 5), None)], hist=[],
        filters=[("fs", "re", "str", 0), ("fr", "nre", "str", 0),
                 ("g", "in", "set", 1), ("g", "nin", "set", 2)],
        fcols={"fs": (-2, 12), "fr": (-2, 12)}),
    "an unknown op: every row unmatched": dict(
        B=3, C=4096, keys=[((0, 5), (0, 5))], hist=[],
        filters=[("fi", "zz", "int", 0)]),
    "17 filters (constants past the staged 16)": dict(
        B=2, C=4096, keys=[((0, 5), None)], hist=[],
        filters=[(f"f{i}", "gt", "int", 2) for i in range(16)]
        + [("f16", "lt", "int", 40)]),
    "17 keys and 48 filters (the descriptor past its head)": dict(
        B=2, C=1024, keys=[((0, 2), None)] * 17, hist=[],
        filters=[(f"f{i % 4}", "gt", "int", i % 3) for i in range(48)]),
    "17 packed keys and 40 filters (the descriptor past its head)": dict(
        B=2, C=1024, keys=[((0, 2), (0, 2))] * 17, hist=[],
        filters=[(f"f{i % 4}", "gt", "int", i % 3) for i in range(40)]),
    "packed key with the cache-group lane, a spill": dict(
        B=8, C=1024, keys=[((0, 6), (0, 5))], hist=[], cg=2,
        lead_pack=[(0, 3)]),
    "packed key under a time key, a spill": dict(
        B=3, C=4096, keys=[((0, 5), (0, 5))], hist=[],
        time=(-40_000, 90_000, 100, True), lead_pack=[(-40_000, 100_000)]),
    "the matched mask, packed": dict(
        B=3, C=4096, keys=[((0, 5), (0, 5))], hist=[], mask=True,
        filters=[("fi", "gt", "int", 40)]),
    "the matched mask, unpacked under a time key": dict(
        B=3, C=4096, keys=[((0, 5), None)], hist=[], mask=True,
        time=(-40_000, 90_000, 100, True), filters=[("fi", "gt", "int", 40)]),
    "the enum form, weights wrapping mod 2^64": dict(
        B=3, C=4096, keys=[((0, 300), (0, 300))], hist=[], weight="wrap",
        filters=[("fi", "gt", "int", 10)], extra=dict(prune_topk=100)),
    "the enum form without a weight column, a spill": dict(
        B=3, C=4096, keys=[((0, 600), (0, 500)), ((0, 4), (0, 4))], hist=[],
        partial=True, extra=dict(prune_topk=100)),
    "R of 12 rows: a tile cut short": dict(
        B=3, C=4, keys=[((0, 3), None)], hist=[],
        filters=[("fi", "gt", "int", 10)]),
    "R of 320 rows, not a multiple of a warp's tile": dict(
        B=5, C=64, keys=[((0, 3), (0, 3))], hist=[], partial=True),
    "no group keys: one zero lane": dict(B=2, C=1024, keys=[],
                                         hist=[None]),
}
K7_SWEEP_SEED = 16              # the random sweep's shapes
K7_SWEEP = 32


def k7_case(name: str, seed: int = 0):
    """K7_CASES[name] -> sorted_case's numpy batch."""
    return sorted_case(K7_CASES[name],
                       seed + 700 + sorted(K7_CASES).index(name))


def k7_sweep(seed: int = K7_SWEEP_SEED, n: int = K7_SWEEP) -> dict:
    """n seeded random K7 shapes -> {name: sorted_case options}: 0-3
    filters of every op, 0-3 keys of each kind, packed (int32 or int64,
    with spills) or unpacked (MISSING and negative values), a time key
    (int32 or int64 arithmetic, negative times), distinct lanes, the
    cache-group lane, the mask, the enum form (weights wrapping or
    none), batches of 1-5 blocks of 4-8,192 rows, a short block."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ops = [("fi", "gt", "int"), ("fi", "lt", "int"), ("fe", "eq", "str"),
           ("fe", "neq", "str"), ("fs", "re", "str"), ("fs", "nre", "str"),
           ("g", "in", "set"), ("g", "nin", "set")]
    out = {}
    for i in range(n):
        form = ("lanes", "packed", "enum")[i % 3]
        o = dict(B=int(rng.integers(1, 6)), C=2 ** int(rng.integers(2, 14)),
                 hist=[None], partial=bool(rng.integers(0, 2)),
                 fcols={"fe": (0, 4), "fs": (-2, 12)})
        o["filters"] = [ops[j] + (int(rng.integers(0, 60)) if j < 2 else
                                  int(rng.integers(0, 4)),)
                        for j in rng.integers(0, len(ops),
                                              int(rng.integers(0, 4)))]
        nk = int(rng.integers(0 if form == "lanes" else 1, 4))
        if form == "lanes":
            o["keys"] = [((int(rng.integers(-50, 1)),
                           int(rng.integers(1, 50))), None)
                         for _ in range(nk)]
            if rng.integers(0, 2):
                o["time"] = ((-1 << 34, 1 << 34, 7, False) if
                             rng.integers(0, 2) else
                             (-400_000, 900_000, 100, True))
            if rng.integers(0, 3) == 0:
                o["distinct"] = [(-3, 9)] * int(rng.integers(1, 3))
            if rng.integers(0, 3) == 0:
                o["cg"] = 2 ** int(rng.integers(0, 3))
            o["mask"] = bool(rng.integers(0, 2))
        else:
            wide = form == "packed" and rng.integers(0, 2)
            o["keys"] = []
            for _ in range(nk):
                card = int(rng.integers(1, 60000 if wide else 40))
                o["keys"].append(((0, card + int(rng.integers(0, 3))),
                                  (0, card)))
            if form == "enum":
                o["extra"] = dict(prune_topk=100)
                o["weight"] = ("wrap", True, False)[int(rng.integers(0, 3))]
            else:
                o["mask"] = bool(rng.integers(0, 2))
        out[f"sweep {i} ({form})"] = o
    return out


# sort_permute's and sort_rows' own cases: name -> (rows, the lanes'
# value ranges [lo, hi), None for a lane of SENTINEL alone); lane 0 is
# the most significant
PERMUTE_CASES = {
    "two lanes": (5000, [(0, 9), (0, 1000)]),
    "three lanes: a base": (5000, [(0, 5), (0, 3), (-5, 200)]),
    "four lanes, ties everywhere": (4096, [(0, 2)] * 4),
    "every row SENTINEL": (3000, [None] * 3),
    "R = 1": (1, [(0, 5), (0, 5)]),
    # an H100's 528 CTAs of sort_permute (4 a SM) take 5 or 6 chunks of
    # 512 rows each, in their sources' order: lane 1's sort leaves 9
    # ascending runs in p
    "more chunks than CTAs": (1_500_000, [(0, 1 << 40), (0, 9)]),
}


def permute_case(name: str, seed: int = 0):
    """PERMUTE_CASES[name] -> its lanes, int64 [n, R] numpy."""
    import numpy as np
    R, lanes = PERMUTE_CASES[name]
    rng = np.random.default_rng(seed + 900 + sorted(PERMUTE_CASES).index(
        name))
    return np.stack([np.full(R, I64_MAX, np.int64) if lane is None else
                     rng.integers(*lane, R) for lane in lanes])


def k7_tensors(case, device):
    """sorted_case's numpy batch on `device` -> (config, cols, nrec,
    filter constants, bitsets, time bucket, the set filters' K14 masks
    or None)."""
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.query.engine import pad_set_csr
    fields, cols, nrec, fv, bits, tb, sets = case
    cfg = scan.config_from_fields(fields)
    tcols = {k: (torch.from_numpy(v).to(device),
                 torch.from_numpy(m).to(device))
             for k, (v, m) in cols.items()}
    fv_t = torch.from_numpy(fv).to(device)
    R = nrec.size * next(iter(cols.values()))[0].shape[1]
    sm = None
    if sets:
        aux = {}
        for col, (rows, vals) in sets.items():
            prow, pval = pad_set_csr(rows, vals, R)
            aux[col] = (torch.from_numpy(prow).to(device),
                        torch.from_numpy(pval).to(device), len(rows))
        sm = scan.set_filter_masks(cfg, fv_t, aux, R)
    return (cfg, tcols, torch.from_numpy(nrec).to(device), fv_t,
            tuple(torch.from_numpy(b).to(device) for b in bits), tb, sm)


def sort_rows_plain(keys):
    """sort_rows over the key lanes [n, R] with sort_permute_plain between
    the stable sorts."""
    import torch

    from sybil_tpu_torch.ops import scan
    svals, p = torch.sort(keys[-1], stable=True)
    base = None
    for k in range(keys.shape[0] - 2, -1, -1):
        base, g = scan.sort_permute_plain(base, p, keys[k])
        svals, p = torch.sort(g, stable=True)
    return {"skey": None, "p": p, "base": base, "svals": svals}


def order_check(what, lanes, errs) -> None:
    """sort_rows (sort_permute between its sorts) against the plain
    steps, and each step's sort_permute against its plain version."""
    import torch

    from sybil_tpu_torch.ops import scan
    got = scan.sort_rows(None, {"key": None, "keys": lanes})
    want = sort_rows_plain(lanes)
    for key in ("p", "base", "svals"):
        if (got[key] is None) != (want[key] is None):
            fail(f"sort_rows {what}: {key} present on one side only")
        if got[key] is not None:
            check_equal(f"sort_rows {what} {key}", got[key], want[key],
                        errs["sort_permute"])
    p = torch.sort(lanes[-1], stable=True)[1]
    base = None
    for k in range(lanes.shape[0] - 2, -1, -1):
        nb, g = scan.sort_permute(base, p, lanes[k])
        nbp, gp = scan.sort_permute_plain(base, p, lanes[k])
        check_equal(f"sort_permute {what} perm", nb, nbp,
                    errs["sort_permute"])
        check_equal(f"sort_permute {what} lane {k}", g, gp,
                    errs["sort_permute"])
        base = nb
        p = torch.sort(g, stable=True)[1]


def k7_edge_checks(card, device, errs) -> None:
    """K7 against its plain version, word for word, on K7_CASES and a
    seeded random sweep (k7_sweep), each unpacked batch's sort_rows and
    sort_permute steps against the plain steps, and PERMUTE_CASES; fails
    unless every template choice of the kernel (scan.K7_PATHS: the enum
    form, the mask, the cache-group lane, the time key, both places of
    the descriptor, unpacked, packed int32 and int64, distinct lanes)
    ran."""
    import torch

    from sybil_tpu_torch.ops import scan
    paths = torch.zeros(len(scan.K7_PATHS), dtype=torch.int64,
                        device=device)
    sweep = k7_sweep()
    cases = [(name, k7_case(name)) for name in K7_CASES] + [
        (name, sorted_case(o, K7_SWEEP_SEED + i))
        for i, (name, o) in enumerate(sweep.items())]
    for name, case in cases:
        cfg, cols, nrec, fv, bits, tb, sm = k7_tensors(case, device)
        got = scan.sorted_front(cfg, cols, nrec, fv, bits, tb, sm,
                                paths=paths)
        check_outs("sorted_front", f"case {name!r}", got,
                   scan.sorted_front_plain(cfg, cols, nrec, fv, bits, tb,
                                           sm),
                   ("key", "keys", "idxm", "spill", "totals", "mask"), errs)
        if got["keys"] is not None and got["keys"].shape[0] > 1:
            order_check(f"case {name!r}", got["keys"], errs)
    for name in PERMUTE_CASES:
        order_check(f"case {name!r}",
                    torch.from_numpy(permute_case(name)).to(device), errs)
    n = dict(zip(scan.K7_PATHS, paths.tolist()))
    if not all(n.values()):
        fail(f"K7's checks never took {[k for k, v in n.items() if not v]}:"
             f" {n}")
    say(f"[{card}] K7 sorted_front == plain (tolerance 0) on "
        f"{len(K7_CASES)} cases ({', '.join(K7_CASES)}) and a random sweep "
        f"of {len(sweep)} shapes (seed {K7_SWEEP_SEED}); sort_rows and "
        f"sort_permute == plain on their unpacked lanes and "
        f"{len(PERMUTE_CASES)} cases ({', '.join(PERMUTE_CASES)}); CTAs "
        f"by template choice: {n}")


def sorted_edge_expect(name, cfg, main, R):
    """Each edge batch reaches the edge it is named for."""
    from sybil_tpu_torch.ops import scan
    meta = main[0].tolist()
    H = len(scan.hist_aggs(cfg))
    layout = scan.packed_layout(cfg, R)
    ok = {
        "packed key past 2^31 (int64)":
            scan.pack_sentinel(cfg)[1] is not None
            and str(scan.pack_sentinel(cfg)[1]) == "torch.int64",
        "packed spill": meta[1] > 0,
        "groups past prefix_rows": meta[0] > scan.table_prefix(cfg),
        "hist pairs past Hcap": meta[7 + H] > layout.get("Hcap", 0),
        "group cap: max_groups 1000 under 5000 groups":
            meta[0] > cfg.max_groups,
    }.get(name, True)
    if cfg.track_outliers and name != "packed spill":
        ok = ok and meta[2] > 0
    if (meta[1] > 0) != (name == "packed spill"):
        ok = False
    if not ok:
        fail(f"sorted edge batch {name}: meta {meta[:8 + 2 * H]} misses "
             f"its edge")


# ---------------------------------------------------------------------------
# K9 (hist_prep, hist_pairs) and K5 (outlier_compact): corner cases
# ---------------------------------------------------------------------------

# K9's corner cases (tests/test_torch_hist_outlier_cases.py holds the
# plain versions to the reference's _scan_sorted, its pair arrays at the
# rows hp_mask sets and at row R-1, and its outlier outputs, on the same
# batches made smaller): name -> options.  B: blocks of C rows (65,536 on
# the card); T = C // 4 rows (16,384 on the card: four of hist_pairs'
# 4,096-row tiles, one of K5's and K10's).
# segs: the (group, bucket) segments in the pair sort's order, each
# ((tiles, rows), key, value) of tiles * T + rows rows, or (-1, key,
# value) for the rows the others leave; the packed group key "k0" and
# the value "v" (value-identity buckets) make them, the batch shuffled.
# rest: (kind, (tiles, rows) or -1) rows after the segments: "unmatched"
# (the filter drops them: hist_prep gathers nothing for them) or
# "missing" (matched, no value: the sentinel segment).  random: (keys,
# lo, hi): every row a random key in [0, keys) and value in [lo, hi)
# instead.  hist: (nv, max_groups) of the value-identity buckets
# (default (40, 100,000)), or "multi" (MULTI_EDGES); weight: "small"
# (1-100) or "huge" (+-2^62: the sums wrap mod 2^64), 80% valid; track:
# outlier tracking.
K9_CASES = {
    "one segment across 160 tiles, weighted": dict(
        B=48, segs=[((0.3, 0), 0, 3), ((160, 0), 0, 5), (-1, 1, 7)],
        rest=("unmatched", (28, 0)), weight="small"),
    "one segment across 160 tiles, row counts": dict(
        B=48, segs=[((0.3, 0), 0, 3), ((160, 0), 0, 5), (-1, 1, 7)],
        rest=("missing", (28, 0))),
    "segments on tile, chunk and thread edges": dict(
        B=4, segs=[((1, 0), 0, 1), ((1, 0), 0, 2), ((0, 1), 0, 3),
                   ((1, -2), 0, 4), ((0, 1), 0, 5), ((0.25, 0), 1, 0),
                   ((0, 16), 1, 1), ((0, 15), 1, 2), ((0, 17), 1, 3),
                   ((0.25, -48), 1, 4), ((2, 0), 2, 9), ((0, 1), 3, 0),
                   ((3, 5), 3, 1), (-1, 4, 39)],
        rest=("unmatched", (1, 3))),
    "every row unmatched": dict(B=4, rest=("unmatched", -1)),
    "every row in the sentinel segment": dict(B=4, rest=("missing", -1),
                                              weight="small"),
    "row R-1 a valid segment start": dict(
        B=4, segs=[((3, 0), 0, 1), (-1, 0, 2), ((0, 1), 5, 0)],
        weight="small", track=True),
    "the last segment ends on row R-1, across tiles": dict(
        B=4, segs=[((0.05, 0), 0, 1), (-1, 1, 3)], weight="huge"),
    "weights of +-2^62 wrap mod 2^64": dict(
        B=4, segs=[((2, 0), 0, 1), ((3, 7), 0, 2), ((0, 3), 1, 0),
                   (-1, 1, 1)], rest=("missing", (2, 0)), weight="huge"),
    "multihist sub-ranges, live outliers": dict(
        B=4, random=(7, -20, 450), hist="multi", weight="small",
        track=True),
    "int32 pair key, (S+1)nv just under 2^31": dict(
        B=4, random=(70000, 0, 40000), hist=(32768, 65534), track=True),
    "int64 pair key, (S+1)nv at 2^31": dict(
        B=4, random=(70000, 0, 40000), hist=(32768, 65535), track=True,
        weight="small"),
}


def k9_case(name: str, C: int = 65536, seed: int = 0):
    """K9_CASES[name] -> (ScanConfig fields with aggs and filters as field
    dicts, {col: (values int64 [B, C], valid bool [B, C])}, nrec int32
    [B], filter constants int64 [1], time bucket), all numpy, made from
    the seed."""
    import numpy as np
    o = K9_CASES[name]
    B = o["B"]
    R, T = B * C, C // 4
    rng = np.random.default_rng(seed + 900 + sorted(K9_CASES).index(name))

    def rows(c):
        return int(c[0] * T) + c[1]
    segs = o.get("segs", [])
    kind, rc = o.get("rest", (None, (0, 0)))
    fixed = sum(rows(c) for c, _, _ in segs if c != -1)
    fixed += rows(rc) if rc != -1 else 0
    fill = R - fixed
    if fill < 0 or (fill and not o.get("random") and rc != -1 and
                    all(c != -1 for c, _, _ in segs)):
        raise ValueError(f"K9 case {name!r}: its rows do not make {R}")
    if o.get("random"):
        nk, lo, hi = o["random"]
        k, v = rng.integers(0, nk, R), rng.integers(lo, hi, R)
        ok, f = np.ones(R, bool), np.ones(R, np.int64)
    else:
        parts = [(fill if c == -1 else rows(c), key, val)
                 for c, key, val in segs]
        k = np.concatenate([np.full(n, key) for n, key, _ in parts]
                           + [np.zeros(0, np.int64)])
        v = np.concatenate([np.full(n, val) for n, _, val in parts]
                           + [np.zeros(0, np.int64)])
        nrest = fill if rc == -1 else rows(rc)
        top = max([key for _, key, _ in segs], default=0)
        k = np.concatenate([k, rng.integers(0, top + 1, nrest)])
        v = np.concatenate([v, rng.integers(0, 40, nrest)])
        ok = np.arange(R) < R - nrest if kind == "missing" else \
            np.ones(R, bool)
        f = (np.arange(R) < R - nrest if kind == "unmatched"
             else np.ones(R, bool)).astype(np.int64)
    perm = rng.permutation(R)
    cols = {"k0": (k[perm].reshape(B, C), np.ones((B, C), bool)),
            "v": (v[perm].reshape(B, C), ok[perm].reshape(B, C)),
            "f": (f[perm].reshape(B, C), np.ones((B, C), bool))}
    if o.get("weight"):
        w = (rng.integers(1, 101, R) if o["weight"] == "small"
             else rng.integers(-2 ** 62, 2 ** 62, R))
        cols["w"] = (w.reshape(B, C), (rng.random(R) < 0.8).reshape(B, C))
    if o.get("hist") == "multi":
        agg, S = dict(col="v", hist_min=0, bucket_size=0, num_values=70,
                      discard_min=0, discard_max=2500,
                      sub_edges=MULTI_EDGES), 100_000
    else:
        nv, S = o.get("hist", (40, 100_000))
        agg = dict(col="v", hist_min=0, bucket_size=1, num_values=nv,
                   discard_min=0, discard_max=10 ** 6)
    fields = dict(group_cols=("k0",), aggs=(agg,),
                  filters=(dict(col="f", op="eq", kind="int",
                                bitset_idx=-1),),
                  weight_col="w" if o.get("weight") else "",
                  force_sorted=True, max_groups=S,
                  track_outliers=bool(o.get("track")),
                  sort_pack=((0, int(k.max()) + 1),))
    return (fields, cols, np.full(B, C, dtype=np.int32),
            np.asarray([1], np.int64), 1)


def k9_case_expect(name: str, cfg, prep: dict, hp: dict, T: int) -> None:
    """Each K9 case reaches the edge it is named for (numpy or torch
    outputs of either version): its pair-key width, the set rows, the
    outliers."""
    import numpy as np
    mask = np.asarray(hp["hp_mask"].cpu() if hasattr(hp["hp_mask"], "cpu")
                      else hp["hp_mask"])
    R = mask.size
    set_rows = np.flatnonzero(mask)
    nv = cfg.aggs[0].num_values
    wide = (cfg.max_groups + 1) * nv >= 2 ** 31
    if (str(prep["pairkey"].dtype).endswith("int64")) != wide:
        fail(f"K9 case {name!r}: pair key {prep['pairkey'].dtype} at "
             f"(S+1)nv = {(cfg.max_groups + 1) * nv}")
    nout = prep["nout"]
    tiles = 160 * T
    ok = {
        "one segment across 160 tiles, weighted":
            lambda: np.diff(set_rows).max(initial=0) >= tiles,
        "one segment across 160 tiles, row counts":
            lambda: np.diff(set_rows).max(initial=0) >= tiles,
        "segments on tile, chunk and thread edges":
            lambda: all(mask[[T, 2 * T, 2 * T + 1, 3 * T - 1, 3 * T]]),
        "every row unmatched": lambda: set_rows.size == 0,
        "every row in the sentinel segment": lambda: set_rows.size == 0,
        "row R-1 a valid segment start": lambda: bool(mask[R - 1]),
        "the last segment ends on row R-1, across tiles":
            lambda: set_rows.size == 2 and set_rows[-1] < R - 10 * T,
        "multihist sub-ranges, live outliers": lambda: int(nout[0]) > 0,
        "int32 pair key, (S+1)nv just under 2^31": lambda: int(nout[0]) > 0,
        "int64 pair key, (S+1)nv at 2^31": lambda: int(nout[0]) > 0,
    }.get(name, lambda: True)()
    if not ok:
        fail(f"K9 case {name!r} misses its edge: {set_rows.size} set rows "
             f"of {R}")


def k9_edge_checks(card, device, errs) -> None:
    """K7 to K10 on K9_CASES (sorted_check: K9's two entries and K5 each
    held to its plain version word for word, hist_pairs' outputs at the
    rows its readers read), each case checked to reach its edge; then
    fails unless hist_pairs' checks so far took a look-back and one past
    128 tiles.  A call's device operations are checked late (hist_prep
    1, hist_pairs at most 2)."""
    import torch

    from sybil_tpu_torch.ops import scan
    t0 = time.perf_counter()
    for name in K9_CASES:
        fields, cols, nrec, fv, tb = k9_case(name)
        cfg = scan.config_from_fields(fields)
        tc = {k: (torch.from_numpy(v).to(device),
                  torch.from_numpy(m).to(device))
              for k, (v, m) in cols.items()}
        _, _, parts = sorted_check(
            f"K9 case {name!r}", cfg, tc, torch.from_numpy(nrec).to(device),
            errs, torch.from_numpy(fv).to(device), (), tb)
        prep, hp = parts["preps"][0], parts["pairs"][0]
        k9_case_expect(name, cfg, prep, hp, cols["k0"][0].shape[1] // 4)
        if name == "one segment across 160 tiles, weighted":
            k8 = parts["k8"]
            spk, si2 = torch.sort(prep["pairkey"], stable=True)
            LATE_OP_CHECKS.append((
                f"hist_prep ({name})", 1,
                lambda a=(cfg, 0, tc, k8): scan.hist_prep(*a)))
            LATE_OP_CHECKS.append((
                f"hist_pairs ({name})", 2,
                lambda a=(cfg, 0, spk, si2, prep["w"], k8["kmat"]):
                scan.hist_pairs(*a)))
        del parts, prep, hp
    n = dict(zip(scan.K9_PATHS, k9_paths(device).tolist()))
    if not all(n.values()):
        fail(f"K9's checks never took every path: {n}")
    say(f"[{card}] K9 hist_prep and hist_pairs == plain (tolerance 0) on "
        f"{len(K9_CASES)} cases in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(K9_CASES)}); hist_pairs' paths over every checked "
        f"launch: {n}")


# K5's corner cases (tests/test_torch_hist_outlier_cases.py holds the
# plain version to the reference's _mask_positions and pack_outputs'
# outlier section on the same batches, made smaller): name -> options.
# B, C: the batch (4 x 65,536 on the card; a tile is T = C // 4 rows,
# outlier_compact's 16,384 there); live: the mask's set rows, "none",
# "kmax" (exactly kmax, spread over the batch), "all", "from tile 3"
# (every row from 3 T on), "R-1" (row R-1 and 20 more), "edges" (k T - 1,
# k T and k T + 1 for each tile k); keys: "cols" (two int group columns
# with MISSING), "cg" (the cache-group key ahead of them, 4 blocks a
# group), "time32" / "time64" (a rollup's time key ahead of them), "kmat"
# (the sorted strategy's key rows), "kmat only" (a multi-process mesh's
# compacted rows: no columns); max_out (1,024); W: the row's words (the
# keys, value and live, and 3 more).
K5_CASES = {
    "no live row": dict(live="none"),
    "exactly kmax live rows": dict(live="kmax"),
    "every row live (past kmax)": dict(live="all"),
    "live rows from tile 3 on": dict(live="from tile 3"),
    "a live row R-1": dict(live="R-1"),
    "live rows on tile edges, kmat keys": dict(live="edges", keys="kmat"),
    "the cache-group key": dict(B=16, live="kmax", keys="cg"),
    "the time key, int32": dict(live="R-1", keys="time32"),
    "the time key, int64": dict(live="edges", keys="time64"),
    "kmat keys, every row live": dict(live="all", keys="kmat"),
    "a mesh's compacted rows (kmat, no columns)": dict(
        B=1, C=3000, live="R-1", keys="kmat only"),
    "max_out 5 under many live rows": dict(live="edges", max_out=5),
    "a batch shorter than kmax": dict(B=1, C=512, live="all"),
    "a 600-word row (past the shared copy)": dict(live="R-1", W=600),
}


def k5_case(name: str, C: int = 65536, seed: int = 0):
    """K5_CASES[name] -> (ScanConfig fields with aggs as field dicts,
    {col: (values int64 [B, C], valid bool [B, C])} or None, mask bool
    [R], values int64 [R], kmat int64 [R, K] or None, W, time bucket),
    all numpy, made from the seed."""
    import numpy as np
    o = K5_CASES[name]
    B, C = o.get("B", 4), o.get("C", C)
    R, T = B * C, C // 4
    rng = np.random.default_rng(seed + 950 + sorted(K5_CASES).index(name))
    max_out = o.get("max_out", 1024)
    kmax = min(max_out, R)
    live = o["live"]
    mask = np.zeros(R, bool)
    if live == "kmax":
        mask[rng.choice(R, kmax, replace=False)] = True
    elif live == "all":
        mask[:] = True
    elif live == "from tile 3":
        mask[3 * T:] = True
    elif live == "R-1":
        mask[rng.choice(R - 1, 20, replace=False)] = True
        mask[R - 1] = True
    elif live == "edges":
        for e in range(T, R, T):
            mask[e - 1: e + 2] = True
    keys = o.get("keys", "cols")
    cols = {} if keys != "kmat only" else None
    groups, extra, tb = ["k0", "k1"], {}, 1
    if cols is not None:
        for g in groups:
            cols[g] = (rng.integers(-50, 50, R).reshape(B, C),
                       (rng.random(R) < 0.9).reshape(B, C))
        cols["v"] = (rng.integers(0, 500, R).reshape(B, C),
                     np.ones((B, C), bool))
    if keys == "cg":
        groups = ["__cg__"] + groups
        extra = dict(vg_span=4)
    elif keys in ("time32", "time64"):
        lo, hi, tb = ((-400_000, 900_000, 100) if keys == "time32" else
                      ((1 << 33) - 5_000_000, (1 << 33) + 5_000_000, 7))
        cols["t"] = (rng.integers(lo, hi, R).reshape(B, C),
                     (rng.random(R) < 0.95).reshape(B, C))
        extra = dict(time_col="t", time_i32=keys == "time32")
    fields = dict(group_cols=tuple(groups),
                  aggs=(dict(col="v", hist_min=0, bucket_size=10,
                             num_values=40, discard_min=0,
                             discard_max=2500),),
                  filters=(), track_outliers=True, max_out=max_out,
                  **extra)
    K = len(groups) + (1 if "time_col" in extra else 0)
    kmat = (rng.integers(-2 ** 40, 2 ** 40, (R, K))
            if keys in ("kmat", "kmat only") else None)
    vals = np.where(mask, rng.integers(-2 ** 50, 2 ** 50, R), 0)
    return fields, cols, mask, vals, kmat, o.get("W", K + 5), tb


def k5_edge_checks(card, device, errs) -> None:
    """K5 on K5_CASES, each launch's rows held to the plain version's word
    for word in a FILL-filled buffer (the rows outside the section must
    stay FILL); a call's device operations are checked late (1: the
    kernel, no memset)."""
    import torch

    from sybil_tpu_torch.ops import scan
    lines = []
    for name in K5_CASES:
        fields, cols, mask, vals, kmat, W, tb = k5_case(name)
        cfg = scan.config_from_fields(fields)
        tc = None if cols is None else {
            k: (torch.from_numpy(v).to(device),
                torch.from_numpy(m).to(device)) for k, (v, m) in cols.items()}
        R = mask.size
        kmax = min(cfg.max_out, R)
        km = None if kmat is None else torch.from_numpy(kmat).to(device)
        mt = torch.from_numpy(mask).to(device)
        vt = torch.from_numpy(vals).to(device)
        got = torch.full((kmax + 5, W), FILL, dtype=torch.int64,
                         device=device)
        want = got.clone()
        scan.outlier_compact(cfg, tc, mt, vt, got, 2, tb, kmat=km)
        scan.outlier_compact_plain(cfg, tc, mt, vt, want, 2, tb, kmat=km)
        check_equal(f"outlier_compact case {name!r}", got, want,
                    errs["outlier_compact"])
        lines.append(f"{name}: {int(mask.sum())} live of {R}")
        if name == "no live row":
            LATE_OP_CHECKS.append((
                f"outlier_compact ({name})", 1,
                lambda a=(cfg, tc, mt, vt, got, 2, tb):
                scan.outlier_compact(*a)))
    say(f"[{card}] K5 outlier_compact == plain word for word on "
        f"{len(K5_CASES)} corner cases: " + "; ".join(lines))


# ---------------------------------------------------------------------------
# K10 and K3 at their wrappers' interfaces: corner cases and sweeps
# ---------------------------------------------------------------------------

# name -> options of a K10 call (sorted_pack) on synthetic group tables:
# K keys, A aggregations (the first H histograms), D distinct columns, R
# mask rows, S slots (max_groups), P prefix_rows; hp / pm the density of
# each hist pair mask / the distinct pair mask ("cap": exactly the
# section's rows set); prune None, -1 ($COUNT) or the scored
# aggregation; ties (counts of few values), dead (count-0 and dead
# slots); merged (a mesh scan's table with the overflow word);
# misalign (the masks 1 byte past 16-byte alignment); extra ScanConfig
# fields
K10_CASES = {
    "no pairs": dict(H=1, hp=0.0),
    "exactly Hcap pairs": dict(H=1, hp="cap", R=50_000,
                               extra=dict(max_hist_pairs=777)),
    "more than Hcap pairs, two sections": dict(
        A=3, H=2, hp=0.3, R=40_000, extra=dict(max_hist_pairs=64)),
    "distinct pairs past max_pairs": dict(D=2, pm=0.4, A=0, R=30_000,
                                          extra=dict(max_pairs=500)),
    "distinct pairs below the cap, a hist section too": dict(
        D=1, pm=0.001, H=1, hp=0.002, R=300_001),
    "path 2: no pair section": dict(K=2, A=1, H=0),
    "prune by $COUNT with ties": dict(A=1, H=0, prune=-1, ties=True,
                                      extra=dict(prune_topk=300)),
    "prune by a mean, count-0 and dead slots": dict(
        A=2, H=0, prune=1, dead=True, extra=dict(prune_topk=1000)),
    "merged table, every aggregation's min and max": dict(
        A=2, H=1, hp=0.05, merged=True),
    "masks not 16-byte aligned, R % 16 != 0": dict(
        H=1, D=1, hp=0.01, pm=0.02, R=70_001, misalign=True),
    "R below one vector, one row a thread": dict(H=1, hp=0.5, R=7),
    "W past 32 words (nine aggregations)": dict(A=9, H=2, hp=0.01),
    "the descriptor past its head (40 hist aggregations)": dict(
        A=40, H=40, hp=0.02, R=2_000, S=300, P=100),
    "prefix = S": dict(H=1, hp=0.01, S=3_000, P=3_000),
    "tracked outliers: K5's rows left alone": dict(H=2, A=2, hp=0.01,
                                                   track=True),
}
K10_SWEEP_SEED = 18             # the random sweeps' shapes (K10 and K3)
K10_SWEEP = 24

# name -> options of a K3 call (dense_pack, dense_keyed) on synthetic
# reduce-space tables: keys [(min, card)], A aggregations (the first H
# histograms, nv buckets), live the share of live slots, hll (the device
# HLL), i32 (lane_row_bounds that pack int32 pairs), keyed (the row-store
# scan's dense_keyed), merged (a mesh scan's table), time (a time key
# first, bucket tb), track (outlier rows), extra ScanConfig fields
K3_CASES = {
    "config 1: compact, avg": dict(keys=[(0, 5)], A=1, H=0),
    "hist sections, Ph above the live slots": dict(
        keys=[(0, 40)], A=2, H=1, live=0.05, extra=dict(hist_prefix=128)),
    "HLL planes, Phll above the live slots": dict(
        keys=[(0, 6)], A=0, hll=True, live=0.5),
    "i32 wire columns, an odd count": dict(keys=[(0, 9), (3, 4)], A=1,
                                           H=0, i32=True),
    "merged keyed table, hist and outlier rows": dict(
        keys=[(0, 5)], A=2, H=1, merged=True, track=True),
    "dense_keyed with a time key": dict(keys=[(-3, 20), (0, 4)], A=1, H=1,
                                        keyed=True, time=3600),
    "dense_keyed, 8,192 slots": dict(keys=[(0, 90), (0, 89)], A=1, H=0,
                                     keyed=True, live=0.3),
    "no live slot": dict(keys=[(0, 7)], A=1, H=1, live=0.0),
    "compact with outlier rows and two hists": dict(
        keys=[(0, 12)], A=3, H=2, track=True),
    "the descriptor past its head (90 aggregations)": dict(
        keys=[(0, 3)], A=90, H=0),
}


def _pack_agg(scan, i: int, hist: bool, nv: int = 12):
    return scan.AggSpec(f"v{i}", 0, 1 if hist else 0, nv if hist else 0, 0,
                        100)


def k10_case(o: dict, seed: int, device):
    """K10_CASES' options -> (ScanConfig, R, the wrapper's arguments
    k8, spill, pairs, nouts, overflow), synthetic tensors on `device`."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    rng = np.random.default_rng(seed)
    K, A, H, D = o.get("K", 1), o.get("A", max(o.get("H", 0), 1)), \
        o.get("H", 0), o.get("D", 0)
    R, S = o.get("R", 100_000), o.get("S", 20_000)
    prune = o.get("prune")
    extra = dict(o.get("extra", {}))
    if prune is not None:
        extra["prune_agg"] = prune
    cfg = scan.ScanConfig(
        group_cols=tuple(f"k{i}" for i in range(K)),
        aggs=tuple(_pack_agg(scan, i, i < H) for i in range(A)),
        filters=(), distinct_cols=tuple(f"d{i}" for i in range(D)),
        force_sorted=True, max_groups=S, prefix_rows=o.get("P", 8192),
        track_outliers=bool(o.get("track")), **extra)
    K = cfg.n_key_cols
    L = 2 + 3 * A
    mmw = A if o.get("merged") else H

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, shape, dtype=np.int64)

    sums = ints(0, 2 ** 40, S + 1, L)
    sums[:, 2::3] = ints(-3, 4, S + 1, A)              # exists lanes
    if o.get("ties"):
        sums[:, 0] = ints(0, 4, S + 1)
    if o.get("dead"):
        dead = rng.random(S + 1) < 0.3
        sums[dead, :2] = 0
        sums[rng.random(S + 1) < 0.3, 3::3] = 0       # count-0 aggs
        sums[:, 4::3] = ints(-10 ** 6, 10 ** 6, S + 1, A)
    k8 = {"sums": t(sums), "keys": t(ints(-5, 10 ** 12, S, K)),
          "mins": t(ints(-100, 100, S, mmw)),
          "maxs": t(ints(-100, 100, S, mmw)),
          "num_groups": t(ints(0, 10 ** 6, 1))}

    def mask(p, cap):
        m = np.zeros(R, bool)
        if p == "cap":
            m[rng.choice(R, cap, replace=False)] = True
        else:
            m = rng.random(R) < p
        if o.get("misalign"):
            buf = torch.zeros(R + 1, dtype=torch.bool, device=device)
            buf[1:] = t(m)
            return buf[1:]
        return t(m)

    layout = scan.packed_layout(cfg, R)
    pairs, nouts = [], []
    for i in range(H):
        pairs.append({"hp_mask": mask(o.get("hp", 0.01), layout["Hcap"]),
                      "hp_keys": t(ints(-5, 10 ** 9, R, K)),
                      "hp_bv": t(ints(0, 12, R)), "hp_w": t(ints(0, 99, R)),
                      "npairs": t(ints(0, R, 1))})
        nouts.append(t(ints(0, 50, 1)) if cfg.track_outliers or i % 2
                     else None)
    if D:
        k8.update(pair_mask=mask(o.get("pm", 0.01), layout["kmax_pairs"]),
                  kmat=t(ints(-5, 10 ** 9, R, K)),
                  dmat=t(ints(-(2 ** 62), 2 ** 62, R, D)))
    overflow = t(ints(0, 9, 1)) if o.get("merged") else None
    return cfg, R, k8, t(ints(0, 5, 1)), pairs, nouts, overflow


def k3_case(o: dict, seed: int, device):
    """K3_CASES' options -> (ScanConfig, R, the wrapper's arguments k2,
    hists, nouts, hll, time bucket), synthetic tensors on `device`."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    rng = np.random.default_rng(seed)
    A, H = o.get("A", 1), o.get("H", 0)
    R = o.get("R", 65_536)
    keyed, merged = bool(o.get("keyed")), bool(o.get("merged"))
    groups = tuple(f"k{i}" for i in range(len(o["keys"])
                                          - (1 if o.get("time") else 0)))
    extra = dict(o.get("extra", {}))
    if o.get("i32"):
        extra["lane_row_bounds"] = (1,) * (2 + 3 * A)
    if o.get("hll"):
        extra.update(hll=True, distinct_cols=("d",))
    cfg = scan.ScanConfig(
        group_cols=groups,
        aggs=tuple(_pack_agg(scan, i, i < H) for i in range(A)),
        filters=(), key_bounds=tuple(o["keys"]),
        time_col="t" if o.get("time") else "",
        track_outliers=bool(o.get("track")),
        no_compact_table=keyed or merged, **extra)
    slots, Sc, _ = scan.reduce_space(cfg)
    if not slots:
        raise ValueError(f"K3 case {o}: not a dense config")
    if merged:
        Sc = slots
    L = 2 + 3 * A

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, shape, dtype=np.int64)

    n = slots + 1 if merged else Sc
    sums = ints(0, 2 ** 20, n, L)
    sums[:, 2::3] = ints(-2, 3, n, A)
    dead = rng.random(n) >= o.get("live", 0.7)
    sums[dead, :2] = 0
    k2 = {"sums": t(sums), "spill": t(ints(0, 5, 1)),
          "mins": t(ints(-9, 9, Sc, A if merged else H)),
          "maxs": t(ints(-9, 9, Sc, A if merged else H))}
    if merged:
        k2.update(keys=t(ints(-1, 10 ** 6, slots, cfg.n_key_cols)),
                  num_groups=t(ints(0, slots, 1)),
                  overflow=t(ints(0, 9, 1)))
    hists = [t(ints(0, 10 ** 6, Sc, cfg.aggs[i].num_values))
             for i in range(H)]
    nouts = [t(ints(0, 99, 1)) if cfg.track_outliers or i % 2 else None
             for i in range(H)]
    hll = (t(rng.integers(0, 50, (slots, scan.HLL_M), dtype=np.uint8))
           if o.get("hll") else None)
    return cfg, R, k2, hists, nouts, hll, o.get("time", 1)


def pack_sweep(kind: str, seed: int = K10_SWEEP_SEED,
               n: int = K10_SWEEP) -> dict:
    """A seeded random sweep of K10 (kind "K10") or K3 ("K3") shapes:
    name -> options as K10_CASES / K3_CASES take them."""
    import numpy as np
    rng = np.random.default_rng(seed + (0 if kind == "K10" else 1))
    out = {}
    for i in range(n):
        if kind == "K10":
            A = int(rng.integers(0, 5))
            o = dict(K=int(rng.integers(0, 4)), A=A,
                     H=int(rng.integers(0, A + 1)),
                     D=int(rng.integers(0, 3)) if rng.random() < 0.4 else 0,
                     R=int(rng.choice([1, 15, 4096, 16_383, 16_385, 99_999,
                                       400_000])),
                     S=int(rng.choice([1, 50, 3_000, 40_000])),
                     P=int(rng.choice([1, 64, 8192])),
                     hp=float(rng.choice([0.0, 0.001, 0.05, 0.9])),
                     pm=float(rng.choice([0.0, 0.01, 0.5])),
                     misalign=bool(rng.random() < 0.3),
                     merged=bool(rng.random() < 0.2),
                     track=bool(rng.random() < 0.2),
                     extra=dict(max_hist_pairs=int(rng.choice([16, 8192])),
                                max_pairs=int(rng.choice([32, 16384]))))
            o["P"] = min(o["P"], o["S"])
            if rng.random() < 0.25 and not o["H"] and not o["D"] and A:
                o.update(prune=int(rng.integers(-1, A)),
                         dead=bool(rng.random() < 0.5),
                         ties=bool(rng.random() < 0.5))
                o["extra"]["prune_topk"] = int(rng.choice([1, 100, 4000]))
                o["merged"] = False
        else:
            nk = int(rng.integers(1, 3))
            keys = [(int(rng.integers(-5, 5)), int(rng.integers(1, 40)))
                    for _ in range(nk)]
            A = int(rng.integers(0, 4))
            form = rng.choice(["compact", "keyed", "merged"])
            o = dict(keys=keys, A=A, H=int(rng.integers(0, A + 1)),
                     live=float(rng.choice([0.0, 0.05, 0.7, 1.0])),
                     i32=bool(rng.random() < 0.4),
                     hll=bool(rng.random() < 0.25),
                     track=bool(rng.random() < 0.3),
                     keyed=form == "keyed", merged=form == "merged",
                     R=int(rng.choice([1000, 65_536])),
                     extra=dict(hist_prefix=int(rng.choice([1, 128, 4096])),
                                hll_ship=int(rng.choice([1, 8, 40]))))
            if o["keyed"] and rng.random() < 0.4:
                o["time"] = int(rng.choice([1, 300, 3600]))
                o["keys"] = [(int(rng.integers(-50, 50)), 30)] + keys[:1]
            if o["hll"]:
                o["merged"] = o["keyed"] = False
                o.pop("time", None)
        out[f"{kind} sweep {i}"] = o
    return out


# (label, device operations a call, call) of the K3, K10, K4, K13, K6, K11,
# K9 and K5 calls whose device work is profiled late (no profiler session
# runs before the mesh phase's launch-count checks): K3, K13, K11,
# hist_prep and K5 one operation, the others at most two
LATE_OP_CHECKS = []


def pack_check(kernel, what, got_main, want_main, lo, hi, errs) -> None:
    """The kernel's `main` against its plain version's, both pre-filled
    with FILL, word for word, and K5's rows [lo, hi) still FILL."""
    check_equal(f"{kernel} {what} main", got_main, want_main, errs)
    if hi > lo and not bool((got_main[lo:hi] == FILL).all()):
        fail(f"{kernel} {what}: K5's rows [{lo}, {hi}) were written")


def k10_edge_checks(card, device, errs) -> None:
    """K10 (sorted_pack, every form) and its enum_pack entry against their
    plain versions, word for word, on K10_CASES and a seeded sweep of
    K10_SWEEP shapes (pack_sweep), each on a `main` pre-filled with FILL:
    every word but K5's rows, which must stay FILL, and under the device
    prune the prefix rows too, left to K12's gather (then both gathers run
    and `main` is compared whole).  enum_pack on three shapes (Pk < P
    among them).  Each form's device operations a call are checked late
    (LATE_OP_CHECKS): at most 2."""
    import torch

    from sybil_tpu_torch.ops import kernels, scan
    t0 = time.perf_counter()
    cases = [(f"case {name!r}", o) for name, o in K10_CASES.items()]
    cases += list(pack_sweep("K10").items())
    forms = {}
    for i, (name, o) in enumerate(cases):
        cfg, R, k8, spill, pairs, nouts, ov = k10_case(
            o, K10_SWEEP_SEED + 1000 + i, device)
        layout = scan.packed_layout(cfg, R)
        shape = (layout["rows"], layout["W"])
        got_main = torch.full(shape, FILL, dtype=torch.int64, device=device)
        want_main = got_main.clone()
        got = scan.sorted_pack(cfg, k8, spill, pairs, nouts, got_main, R,
                               overflow=ov)
        want = scan.sorted_pack_plain(cfg, k8, spill, pairs, nouts,
                                      want_main, R, overflow=ov)
        lo, hi = scan.outlier_rows(cfg, R)
        check_equal(f"sorted_pack {name} table", got["table"],
                    want["table"], errs["sorted_pack"])
        if (got["score"] is None) != (want["score"] is None):
            fail(f"sorted_pack {name}: the score's presence differs")
        P = scan.table_prefix(cfg)
        if got["score"] is not None:
            check_equal(f"sorted_pack {name} score", got["score"],
                        want["score"], errs["sorted_pack"])
            # the prefix rows are K12's gather's: the kernel leaves them
            # as they were (the plain version zeroes them)
            if (device.type == "cuda"
                    and not bool((got_main[1:1 + P] == FILL).all())):
                fail(f"sorted_pack {name}: the pruned prefix was written")
            got_main[1:1 + P] = want_main[1:1 + P]
        pack_check("sorted_pack", name, got_main, want_main, lo, hi,
                   errs["sorted_pack"])
        if got["score"] is not None:
            gm, wm = got_main.clone(), want_main.clone()
            gm[1:1 + P] = FILL
            scan.prune_topk_gather(cfg, got["score"], got["table"], gm)
            pidx = scan.topk_rows_plain(want["score"], P)
            scan.prune_gather_plain(cfg, want["table"], pidx, wm)
            check_equal(f"sorted_pack {name} main after the gather", gm, wm,
                        errs["sorted_pack"])
        form = ("prune" if got["score"] is not None else "merged"
                if ov is not None else "pairs" if pairs or cfg.distinct_cols
                else "table")
        if form not in forms:
            forms[form] = name
            LATE_OP_CHECKS.append((
                f"sorted_pack {form} ({name})", 2,
                lambda a=(cfg, k8, spill, pairs, nouts, got_main, R, ov):
                scan.sorted_pack(*a[:7], overflow=a[7])))
    enums = []
    for i, (what, R, P, K) in enumerate((
            ("1,000 winners of 200,000 users", 400_000, 1000, 1),
            ("Pk < P: 700 rows under a prefix of 1,000", 700, 1000, 2),
            ("three keys, W past 32 (six aggregations)", 50_000, 64, 3))):
        cfg, args = enum_pack_case(K, R, P, 6 if K == 3 else 1,
                                   K10_SWEEP_SEED + 2000 + i, device)
        layout = scan.packed_layout(cfg, R)
        shape = (layout["rows"], layout["W"])
        got_main = torch.full(shape, FILL, dtype=torch.int64, device=device)
        want_main = got_main.clone()
        check_equal(f"enum_pack {what} table",
                    scan.enum_pack(cfg, *args, got_main),
                    scan.enum_pack_plain(cfg, *args, want_main),
                    errs["enum_pack"])
        check_equal(f"enum_pack {what} main", got_main, want_main,
                    errs["enum_pack"])
        enums.append(what)
        if i == 0:
            LATE_OP_CHECKS.append((
                f"enum_pack ({what})", 1,
                lambda a=(cfg, args, got_main): scan.enum_pack(
                    a[0], *a[1], a[2])))
    say(f"[{card}] K10 sorted_pack == plain word for word on a FILL-filled "
        f"main (K5's rows and the pruned prefix left alone) on "
        f"{len(K10_CASES)} cases ({', '.join(K10_CASES)}) and a sweep of "
        f"{K10_SWEEP} shapes (seed {K10_SWEEP_SEED}), forms "
        f"{sorted(forms)}; enum_pack == plain on {'; '.join(enums)} "
        f"({time.perf_counter() - t0:.2f} s)")


def enum_pack_case(K: int, R: int, P: int, A: int, seed: int, device):
    """An enumerated batch's sorted packed keys (K keys of random
    cardinality, some rows past the radix: unmatched), K11-like segments
    and sums, and min(P, R) distinct winner rows -> (ScanConfig,
    (skey, seg, widx, spill, totals))."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    rng = np.random.default_rng(seed)
    bounds = tuple((int(rng.integers(-9, 9)), int(rng.integers(1, 60)))
                   for _ in range(K))
    cfg = scan.ScanConfig(
        group_cols=tuple(f"k{i}" for i in range(K)),
        aggs=tuple(_pack_agg(scan, i, False) for i in range(A)),
        filters=(), force_sorted=True, prune_topk=P, prefix_rows=P,
        sort_pack=bounds)
    radix = scan.enum_radix(cfg)
    if radix <= 0:
        raise ValueError("enum_pack_case: not enumerable")
    skey = np.sort(rng.integers(0, radix + 1, R).astype(np.int32))
    starts = np.r_[True, skey[1:] != skey[:-1]]
    gid = (np.cumsum(starts) - 1).astype(np.int32)
    Smax = scan.enum_slots(cfg, R)
    sums = rng.integers(-5, 10 ** 9, (Smax, 2 + 3 * A), dtype=np.int64)
    Pk = min(scan.table_prefix(cfg), R)
    widx = rng.choice(R, Pk, replace=False).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    seg = {"gid": t(gid), "sums": t(sums),
           "num_groups": t(np.array([starts.sum()], np.int64))}
    return cfg, (t(skey), seg, t(widx), t(np.array([3], np.int64)),
                 t(np.array([R, R - 1], np.int64)))


def k3_edge_checks(card, device, errs) -> None:
    """K3 (dense_pack's compact and merged forms, dense_keyed) against its
    plain version, word for word, on K3_CASES and a seeded sweep of
    K10_SWEEP shapes (pack_sweep), each on a `main` pre-filled with FILL
    whose K5 rows must stay FILL.  Each form's device operations a call
    are checked late (LATE_OP_CHECKS): exactly 1."""
    import torch

    from sybil_tpu_torch.ops import scan
    t0 = time.perf_counter()
    cases = [(f"case {name!r}", o) for name, o in K3_CASES.items()]
    cases += list(pack_sweep("K3").items())
    forms = {}
    for i, (name, o) in enumerate(cases):
        cfg, R, k2, hists, nouts, hll, tb = k3_case(
            o, K10_SWEEP_SEED + 3000 + i, device)
        layout = scan.packed_layout(cfg, R)
        shape = (layout["rows"], layout["W"])
        got_main = torch.full(shape, FILL, dtype=torch.int64, device=device)
        want_main = got_main.clone()
        scan.dense_pack(cfg, k2, hists, nouts, got_main, R, hll, tb)
        scan.dense_pack_plain(cfg, k2, hists, nouts, want_main, R, hll, tb)
        lo, hi = scan.outlier_rows(cfg, R)
        kernel = ("dense_keyed" if cfg.no_compact_table and "keys" not in k2
                  else "dense_pack")
        pack_check(kernel, name, got_main, want_main, lo, hi, errs[kernel])
        form = (kernel + (" merged" if "keys" in k2 else "")
                + (" hll" if hll is not None else "")
                + (" hist" if hists else ""))
        if form not in forms:
            forms[form] = name
            LATE_OP_CHECKS.append((
                f"{form} ({name})", 1,
                lambda a=(cfg, k2, hists, nouts, got_main, R, hll, tb):
                scan.dense_pack(*a)))
    say(f"[{card}] K3 dense_pack and dense_keyed == plain word for word on "
        f"a FILL-filled main (K5's rows left alone) on {len(K3_CASES)} "
        f"cases ({', '.join(K3_CASES)}) and a sweep of {K10_SWEEP} shapes "
        f"(seed {K10_SWEEP_SEED}), forms {sorted(forms)} "
        f"({time.perf_counter() - t0:.2f} s)")


# rounds of late_op_checks: a call whose profiles all recorded nothing is
# profiled again in the next round, LATE_ROUND_GAP_S later
LATE_ROUNDS = 3
LATE_ROUND_GAP_S = 2.0


def late_op_checks(card) -> None:
    """LATE_OP_CHECKS' calls profiled: each must be recorded, and within
    its device operations a call (K3, K13, K11, hist_prep and K5: 1; K10,
    K4, K6's value mode and hist_pairs at most 2).  A
    call the profiler recorded nothing of (device_launches' None: a
    profile that misses a call's events, PERF.md §7) is profiled again in
    a later round, up to LATE_ROUNDS in all; one still unrecorded fails."""
    lines = []
    pending = list(LATE_OP_CHECKS)
    for rnd in range(LATE_ROUNDS):
        missed = []
        for label, most, fn in pending:
            n, per = device_launches(fn)
            if n is None:
                missed.append((label, most, fn, per))
                continue
            if n > most or (most == 1 and n != 1):
                fail(f"{label}: {n} device operations a call ({per}), want "
                     f"{'exactly' if most == 1 else 'at most'} {most}")
            lines.append(f"{label}: {n}" + (f" (round {rnd + 1})" if rnd
                                            else ""))
        if not missed:
            break
        pending = [m[:3] for m in missed]
        time.sleep(LATE_ROUND_GAP_S)
    if missed:
        fail("; ".join(f"{label}: the profiler recorded no device event in "
                       f"{LATE_ROUNDS} rounds ({per}), want "
                       f"{'exactly' if most == 1 else 'at most'} {most}"
                       for label, most, _, per in missed))
    del LATE_OP_CHECKS[:]
    say(f"[{card}] K3, K10, K4, K13, K6's value mode, K11, K9 and K5 "
        f"device operations a call "
        f"(torch.profiler): "
        + "; ".join(lines))


# ---------------------------------------------------------------------------
# phase 4: the enumerated strategy (K7 enum form, K11, K12, K10 enum_pack)
# ---------------------------------------------------------------------------

def enum_check(what, cfg, cols, nrec, errs, fv=None, bits=(), set_aux=None):
    """K14 per set filter, K7's enum form, the sort, K11, K12 and K10's
    enum_pack, each kernel against its plain version on the same inputs,
    word for word; the kernels' buffers against scan_packed's.  -> (main,
    table, {"front", "skey", "p", "seg", "widx"})."""
    import torch

    from sybil_tpu_torch.ops import scan
    if cfg.strategy != "sorted" or scan.enum_radix(cfg) <= 0:
        fail(f"{what}: not the enumerated strategy")
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    dev = nrec.device
    if fv is None:
        fv = torch.zeros(0, dtype=torch.int64, device=dev)
    sm = set_masks_check(what, cfg, fv, set_aux, R, errs)
    front = scan.sorted_front(cfg, cols, nrec, fv, bits, set_masks=sm)
    check_outs("sorted_front", f"{what} (enum form)", front,
               scan.sorted_front_plain(cfg, cols, nrec, fv, bits,
                                       set_masks=sm),
               ("key", "keys", "idxm", "spill", "totals", "mask"), errs)
    skey, p = torch.sort(front["key"], stable=True)
    seg = scan.enum_segments(cfg, cols, skey, p)
    check_outs("enum_segments", what, seg,
               scan.enum_segments_plain(cfg, cols, skey, p),
               ("gid", "sums", "score", "num_groups"), errs)
    k = min(scan.table_prefix(cfg), R)
    widx = scan.topk_rows(seg["score"], k)
    check_equal(f"topk_rows {what} ({seg['score'].dtype} [{R}], k {k})",
                widx, scan.topk_rows_plain(seg["score"], k),
                errs["topk_rows"])
    layout = scan.packed_layout(cfg, R)
    shape = (layout["rows"], layout["W"])
    main = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    main_p = torch.full(shape, FILL, dtype=torch.int64, device=dev)
    table = scan.enum_pack(cfg, skey, seg, widx, front["spill"],
                           front["totals"], main)
    table_p = scan.enum_pack_plain(cfg, skey, seg, widx, front["spill"],
                                   front["totals"], main_p)
    check_equal(f"enum_pack {what} table", table, table_p, errs["enum_pack"])
    check_equal(f"enum_pack {what} main", main, main_p, errs["enum_pack"])
    packed, _ = scan.scan_packed(cfg, cols, nrec, fv, bits, 1, set_aux)
    if not (torch.equal(packed["main"], main)
            and torch.equal(packed["table"], table)):
        fail(f"{what}: scan_packed's buffers differ from the kernels' own")
    return main, table, {"front": front, "skey": skey, "p": p, "seg": seg,
                         "widx": widx}


# name -> options.  keys: [(lo, hi) of the values, (min, card) bound];
# zipf: draw keys from a Zipf law of this exponent; aggs: [(lo, hi) of the
# values, discard (min, max)]; vbias; weight; prune: (prune_topk,
# prune_agg); filters (col, op, kind, constant); p_valid: share of rows
# with the key; nrec; B, C: the batch shape
ENUM_EDGES = {
    "ties across the k boundary": dict(
        keys=[((0, 3000), (0, 3000))], zipf=1.2, prune=(500, -1)),
    "fewer live groups than k": dict(keys=[((0, 40), (0, 40))],
                                     prune=(1000, -1)),
    "R < Pfull": dict(keys=[((0, 300), (0, 300))], prune=(1000, -1), B=1,
                      C=512),
    "a packed spill": dict(keys=[((0, 600), (0, 500)), ((0, 4), (0, 4))],
                           prune=(200, -1)),
    "filters, MISSING keys": dict(
        keys=[((3, 3003), (3, 3000))], p_valid=0.7, prune=(300, -1),
        filters=[("fi", "gt", "int", 10), ("fs", "neq", "str", 4),
                 ("fs", "re", "str", 0)]),
    "two keys, a weight column": dict(
        keys=[((0, 900), (0, 900)), ((2, 11), (2, 9))], weight=True,
        prune=(500, -1)),
    "prune_agg: negative means, a value bias": dict(
        keys=[((0, 5000), (0, 5000))], aggs=[((-900, -10), (-800, -20))],
        vbias=True, weight=True, prune=(1000, 0)),
    "prune_agg without a bias": dict(
        keys=[((0, 5000), (0, 5000))], aggs=[((-300, 300), (-250, 250))],
        prune=(700, 0)),
    "all rows unmatched": dict(keys=[((0, 800), (0, 800))], prune=(1000, 0),
                               nrec=(0, 0, 0)),
}


def enum_edge(name: str, device):
    """A synthetic enumerated batch -> (ScanConfig, cols, nrec,
    filter_vals, bitsets)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.scan import AggSpec, FilterSpec, ScanConfig
    o = ENUM_EDGES[name]
    B, C = o.get("B", 3), o.get("C", 65536)
    R = B * C
    rng = np.random.default_rng(len(name) + 200)
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C))
                     .to(device),
                     torch.from_numpy((rng.random(R) < p_valid)
                                      .reshape(B, C)).to(device))

    groups, pack = [], []
    for i, ((lo, hi), pb) in enumerate(o["keys"]):
        v = (lo + (rng.zipf(o["zipf"], R) - 1) % (hi - lo) if o.get("zipf")
             else rng.integers(lo, hi, R))
        put(f"k{i}", v, o.get("p_valid", 0.95))
        groups.append(f"k{i}")
        pack.append(pb)
    aggs = []
    for a, ((lo, hi), (dmin, dmax)) in enumerate(
            o.get("aggs", [((0, 90), (0, 100))])):
        put(f"v{a}", rng.integers(lo, hi, R), 0.85)
        aggs.append(AggSpec(f"v{a}", hist_min=dmin, bucket_size=0,
                            num_values=0, discard_min=dmin,
                            discard_max=dmax))
    filters, fvals = [], []
    for col, op, kind, val in o.get("filters", ()):
        if col not in cols:
            put(col, rng.integers(0, 80 if col == "fi" else 10, R), 0.9)
        filters.append(FilterSpec(col, op, kind,
                                  0 if op in ("re", "nre") else -1))
        fvals.append(val)
    bits = (torch.from_numpy(np.array([i % 3 != 0 for i in range(10)]))
            .to(device),)
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    prune_topk, prune_agg = o["prune"]
    cfg = ScanConfig(
        group_cols=tuple(groups), aggs=tuple(aggs), filters=tuple(filters),
        weight_col="w" if o.get("weight") else "", sort_pack=tuple(pack),
        key_bounds=tuple(pack), force_sorted=True,
        agg_vbias=(tuple(a.discard_min for a in aggs) if o.get("vbias")
                   else ()), prune_topk=prune_topk, prune_agg=prune_agg)
    nrec = torch.tensor(o.get("nrec", [C, C - 300, C - 3][:B]),
                        dtype=torch.int32, device=device)
    return (cfg, cols, nrec, torch.tensor(fvals, dtype=torch.int64,
                                          device=device), bits)


def enum_edge_expect(name, cfg, main):
    """Each enumerated edge batch reaches the edge it is named for."""
    from sybil_tpu_torch.ops import scan
    meta = main[0].tolist()
    P = scan.table_prefix(cfg)
    live = int((main[1:, 0] != scan.SENTINEL).sum().item())
    ok = meta[4] == P and (meta[1] > 0) == (name == "a packed spill")
    if name == "all rows unmatched":
        ok = ok and meta[0] == 0 and live == 0 and meta[5] == meta[6] == 0
    elif name in ("fewer live groups than k", "R < Pfull"):
        ok = ok and 0 < meta[0] < P and live == meta[0]
    else:
        ok = ok and meta[0] > P
    if name == "ties across the k boundary":
        counts = main[1:, 1]
        ok = ok and int((counts == counts[-1]).sum().item()) > 1
    if name == "filters, MISSING keys":
        ok = ok and bool((main[1:, 0] == scan.MISSING).any().item())
    if not ok:
        fail(f"enum edge batch {name}: meta {meta[:7]}, {live} live rows, "
             f"misses its edge")


def enum_winners_expect(what, cfg, cols, nrec, table):
    """The mean-scored enumerated winners by numpy over a decoded batch of
    config 5's shape (one key, one aggregation, no filter or weight
    column): per packed key its rows, kept rows and biased sum wv =
    Σ(value - bias); the score f32(wv) / f32(kept rows); the first Pk
    groups by score descending, ties to the lower packed key; against
    the table's keys, counts, kept rows and wv."""
    import numpy as np

    from sybil_tpu_torch.ops import scan
    if (len(cfg.group_cols) != 1 or len(cfg.aggs) != 1 or cfg.filters
            or cfg.weight_col or cfg.prune_agg != 0):
        fail(f"{what}: enum_winners_expect takes config 5's shape")
    (mn, card), = cfg.sort_pack
    kv, km = (x.cpu().numpy().reshape(-1) for x in cols[cfg.group_cols[0]])
    B, C = cols[cfg.group_cols[0]][0].shape
    inr = (np.arange(C)[None, :] < nrec.cpu().numpy()[:, None]).reshape(-1)
    digit = np.where(km, kv - mn + 1, 0)
    ok = inr & (digit >= 0) & (digit <= card)
    digit = digit[ok]
    agg = cfg.aggs[0]
    av, am = (x.cpu().numpy().reshape(-1)[ok] for x in cols[agg.col])
    keep = am & (av >= agg.discard_min) & (av <= agg.discard_max)
    bias = cfg.agg_vbias[0] if cfg.agg_vbias else 0
    cnt = np.bincount(digit, minlength=card + 1)
    kept = np.bincount(digit, weights=keep.astype(np.float64),
                       minlength=card + 1)
    wv = np.bincount(digit, weights=np.where(keep, av - bias, 0).astype(
        np.float64), minlength=card + 1)
    if np.abs(wv).max() >= 2 ** 53:
        fail(f"{what}: a wv sum is not exact in float64")
    kept, wv = kept.astype(np.int64), wv.astype(np.int64)
    groups = np.nonzero(cnt)[0]
    if (kept[groups] == 0).any():
        fail(f"{what}: a group without kept rows (-inf score)")
    score = (wv[groups].astype(np.float32)
             / kept[groups].astype(np.float32))
    n = min(scan.table_prefix(cfg), B * C, len(groups))
    win = groups[np.lexsort((groups, -score))[:n]]
    t = table[:n].cpu().numpy()
    want = np.stack([np.where(win == 0, scan.MISSING, win - 1 + mn),
                     cnt[win], cnt[win], kept[win], wv[win]], 1)
    if not np.array_equal(t[:, [0, 1, 2, 4, 5]], want):
        fail(f"{what}: the f32-scored winners differ from numpy's")


def numpy_mean_top(table, cfg, cnt, ws, limit=100) -> list:
    """-prune-sort weight's printed users by numpy, on one batch: the
    device's winners by f32(Σ(weight - bias)) / f32(rows), ties to the
    lower packed key (the lower dictionary id), then the printer's stable
    sort by count (-sort's default), the first `limit`."""
    import numpy as np

    from sybil_tpu_torch.ops import scan
    sid = np.full(C5_CARD, -1, np.int64)
    for i, s in enumerate(table.dicts.get("userid").strings):
        sid[int(s[len("person"):])] = i
    users = np.nonzero(cnt)[0]
    bias = cfg.agg_vbias[0] if cfg.agg_vbias else 0
    score = ((ws[users] - cnt[users] * bias).astype(np.float32)
             / cnt[users].astype(np.float32))
    win = users[np.lexsort((sid[users], -score))[:scan.table_prefix(cfg)]]
    return win[np.argsort(-cnt[win], kind="stable")][:limit].tolist()


def topk_edges(device):
    """K12 alone -> [(label, score, k)]: more than 64 equal maxima inside
    one 1,024-row tile, -inf ties (f32), int64 scores, int32 ties over a
    tiny range, k = R."""
    import numpy as np
    import torch
    rng = np.random.default_rng(17)
    s = np.zeros(16 * 1024, np.int32)
    s[:200] = 7
    f = np.where(rng.random(1 << 20) < 0.3,
                 rng.integers(-5, 5, 1 << 20) / 4.0, -np.inf)
    out = [("200 equal maxima in one 1,024-row tile, k 150", s, 150),
           ("f32 with -inf ties, k 1000", f.astype(np.float32), 1000),
           ("int64 scores past 2^40, k 300",
            (rng.integers(-3, 3, 1 << 20) * (1 << 40)).astype(np.int64), 300),
           ("int32 ties over 50 values, k 1000",
            rng.integers(-1, 50, 1 << 20).astype(np.int32), 1000),
           ("k = R = 777", rng.integers(0, 4, 777).astype(np.int64), 777)]
    return [(label, torch.from_numpy(x).to(device), k)
            for label, x, k in out]


# K12's general form, corner cases (tests/test_torch_enum.py holds the
# plain version to lax.top_k on the same scores): name -> (dtype, R, k,
# values).  values: "equal" (one value: -1, 5 or -inf), "extremes" (the
# type's least and greatest values and their neighbours, +-inf in f32),
# "shared56" (int64 scores that share their top 56 bits), "c5" (-1
# around a twentieth of rows holding Zipf counts; k "tie": the middle of
# a run of equal counts), "c5w" (-inf around a tenth holding mean weights
# of {1, 10, 100}: more than k ties at 100), "random" (1,000 values),
# "sparse" (-1 around three scores).  R past 2^18 with one value puts
# more candidates in a round than a buffer holds (the rounds that read
# the scores again).
K12G_CASES = {
    "all -1 (int64)": ("int64", 50_000, 1000, "equal"),
    "all equal past the buffer cap (int64, 1,048,576 rows)": (
        "int64", 1 << 20, 1000, "equal"),
    "all equal (int32), k 4,096": ("int32", 70_000, 4096, "equal"),
    "all -inf (f32)": ("float32", 30_000, 777, "equal"),
    "INT64_MIN and INT64_MAX": ("int64", 60_000, 3000, "extremes"),
    "INT32_MIN and INT32_MAX": ("int32", 60_000, 3000, "extremes"),
    "f32 infinities and extremes": ("float32", 60_000, 3000, "extremes"),
    "top 56 bits shared (int64)": ("int64", 40_000, 1000, "shared56"),
    "config 5's counts, ties straddling k": ("int64", 262_144, "tie", "c5"),
    "config 5's mean weights, ties past k (f32)": (
        "float32", 262_144, 1000, "c5w"),
    "k 4,096 over random int64": ("int64", 100_000, 4096, "random"),
    "k = R (f32)": ("float32", 3000, 3000, "random"),
    "R = 1 (int32)": ("int32", 1, 1, "random"),
    "fewer live than k (int64)": ("int64", 8192, 64, "sparse"),
}
K12G_SWEEP_SEED = 17            # the random sweep's shapes
K12G_SWEEP = 24


def k12g_case(name: str, seed: int = 0):
    """-> (scores [R] (numpy), k) of K12G_CASES[name]."""
    import numpy as np
    dtype, R, k, values = K12G_CASES[name]
    rng = np.random.default_rng(seed + sorted(K12G_CASES).index(name))
    dt = np.dtype(dtype)
    low = -np.inf if dt.kind == "f" else -1
    if values == "equal":
        s = np.full(R, {"int64": -1, "int32": 5}.get(dtype, -np.inf))
    elif values == "extremes":
        if dt.kind == "f":
            top = float(np.finfo(np.float32).max)
            pool = [-np.inf, -top, -1.0, 0.0, 1.5, top, np.inf]
        else:
            lo, hi = int(np.iinfo(dt).min), int(np.iinfo(dt).max)
            pool = [lo, lo + 1, -1, 0, 1, hi - 1, hi]
        s = np.array(pool, dtype=object)[rng.integers(0, len(pool), R)]
    elif values == "shared56":
        s = 0x7ABCDEF012345600 + rng.integers(0, 256, R)
    elif values in ("c5", "c5w"):
        s = np.full(R, low)
        live = rng.random(R) < (0.05 if values == "c5" else 0.1)
        n = np.minimum(rng.zipf(1.3, int(live.sum())), 10 ** 6)
        if values == "c5":
            s[live] = n
        else:
            w = np.array([1, 10, 100])
            s[live] = [w[rng.integers(0, 3, m)].sum() / m
                       for m in np.minimum(n, 50)]
    elif values == "random":
        s = rng.integers(-1000, 1000, R) / (8 if dt.kind == "f" else 1)
    else:
        s = np.full(R, low)
        s[[5, 999, 7000]] = [3, 9, 1]
    s = np.asarray(s).astype(dt)
    if k == "tie":
        # the middle of the first run of 20 or more equal scores at or
        # past rank 500
        v = np.sort(s)[::-1]
        starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
        ends = np.r_[starts[1:], R]
        i = np.flatnonzero((ends - starts >= 20) & (starts >= 500))[0]
        k = int(starts[i] + ends[i]) // 2
    return s, k


def k12g_sweep(seed: int = K12G_SWEEP_SEED, n: int = K12G_SWEEP) -> list:
    """A seeded sweep of K12's general form: -> [(label, scores, k)] of
    random dtype, R (log-uniform to 4,194,304), k (log-uniform to
    min(R, 4,096)) and value range (2, 16 or 1,024 values, or the type's
    full range), a third of rows at the type's background (-1 or -inf)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        dtype = ("int32", "int64", "float32")[j % 3]
        R = int(np.exp(rng.uniform(0, np.log(4_194_304))))
        k = int(np.exp(rng.uniform(0, np.log(min(R, 4096))))) or 1
        span = (2, 16, 1024, None)[rng.integers(0, 4)]
        if span is None:
            s = (rng.standard_normal(R) * 1e30 if dtype == "float32" else
                 rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, R,
                              dtype=dtype, endpoint=True))
        else:
            s = rng.integers(0, span, R)
        s = np.where(rng.random(R) < 1 / 3,
                     -np.inf if dtype == "float32" else -1, s).astype(dtype)
        out.append((f"sweep {j}: {dtype} [{R}], k {k}, "
                    f"{span or 'full range'}", s, k))
    return out


def k12g_edge_checks(card, device, errs) -> None:
    """K12's general form on the card, held to its plain version word for
    word on the K12G_CASES scores and a seeded sweep (k12g_sweep).  (Its
    device work a call is profiled late, with LATE_PROFILES: no profiler
    session runs before the mesh phase's launch checks.)"""
    import torch

    from sybil_tpu_torch.ops import scan
    t0 = time.perf_counter()
    runs = [(f"K12 case {name!r}", *k12g_case(name)) for name in K12G_CASES]
    runs += k12g_sweep()
    for what, s, k in runs:
        sc = torch.from_numpy(s).to(device)
        check_equal(f"topk_rows {what}", scan.topk_rows(sc, k),
                    scan.topk_rows_plain(sc, k), errs["topk_rows"])
    say(f"[{card}] K12 general form == plain word for word on "
        f"{len(K12G_CASES)} corner cases and a {K12G_SWEEP}-shape sweep "
        f"(seed {K12G_SWEEP_SEED}) ({time.perf_counter() - t0:.2f} s)")


# K11's corner cases (tests/test_torch_enum.py runs scan_packed on the same
# batches, made smaller, against the reference's in both enum forms):
# name -> options.  keys: how the one packed key is drawn ("one big": key
# 0 on 60% of the rows, the rest uniform below card; "spans": runs of
# exactly the kernel's range length, scan.enum_ranges; "distinct": every
# row its own key; "uniform": below card); aggs: [(lo, hi) of the values,
# discard (min, max)]; vbias: each aggregation's bias its discard min;
# weight: (lo, hi) of a weight column; prune: (prune_topk, prune_agg);
# unmatched: every block's nrec 0; shape: (B, C) on the card (3 x 65,536
# otherwise: ranges of 96 rows, two steps of 64)
K11_CASES = {
    "a segment across more than 32 ranges": dict(keys="one big", card=500,
                                                 shape=(16, 65536)),
    "segments of a range's length": dict(keys="spans"),
    "every row its own segment": dict(keys="distinct"),
    "all rows unmatched": dict(keys="uniform", card=800, unmatched=True,
                               prune=(100, 0)),
    # 458,752 rows in ranges of 220 on 132 SMs
    "R not a multiple of the range": dict(keys="uniform", card=3000,
                                          shape=(7, 65536)),
    "sums that wrap mod 2^64": dict(
        keys="one big", card=50,
        aggs=[((-2 ** 62, 2 ** 62), (-2 ** 62, 2 ** 62))],
        weight=(-2 ** 62, 2 ** 62)),
    "acnt 0 under prune_agg": dict(keys="uniform", card=20000,
                                   aggs=[((-100, 100), (90, 100))],
                                   vbias=True, weight=(0, 2), prune=(200, 0)),
    "33 aggregations": dict(keys="uniform", card=1000,
                            aggs=[((0, 90), (0, 100))] * 33,
                            weight=(0, 101)),
}


def k11_case(name: str, B: int, C: int, span: int = 48, seed: int = 0):
    """K11's corner case `name` as numpy arrays -> (scan config fields, as
    k2w_config takes them; {col: (values int64 [B, C], valid bool [B,
    C])}; nrec int32 [B]).  span: the kernel's range length (the
    "spans" case's runs)."""
    import numpy as np
    o = K11_CASES[name]
    rng = np.random.default_rng(seed + sorted(K11_CASES).index(name))
    R = B * C
    how = o["keys"]
    if how == "one big":
        key = np.where(rng.random(R) < 0.6, 0, rng.integers(1, o["card"], R))
        card = o["card"]
    elif how == "spans":
        key = rng.permutation(np.arange(R) // span)
        card = -(-R // span)
    elif how == "distinct":
        key, card = rng.permutation(R), R
    else:
        key, card = rng.integers(0, o["card"], R), o["card"]
    cols = {"k0": (key.astype(np.int64).reshape(B, C),
                   np.ones((B, C), bool))}
    aggs = []
    for a, ((lo, hi), (dmin, dmax)) in enumerate(
            o.get("aggs", [((0, 90), (0, 100))])):
        cols[f"v{a}"] = (rng.integers(lo, hi, R).reshape(B, C),
                         (rng.random(R) < 0.85).reshape(B, C))
        aggs.append((f"v{a}", dict(hist_min=dmin, bucket_size=0,
                                   num_values=0, discard_min=dmin,
                                   discard_max=dmax)))
    if "weight" in o:
        cols["w"] = (rng.integers(*o["weight"], R).reshape(B, C),
                     (rng.random(R) < 0.9).reshape(B, C))
    prune_topk, prune_agg = o.get("prune", (1000, -1))
    fields = dict(group_cols=("k0",), aggs=tuple(aggs), filters=(),
                  weight_col="w" if "weight" in o else "",
                  sort_pack=((0, card),), key_bounds=((0, card),),
                  force_sorted=True, prune_topk=prune_topk,
                  prune_agg=prune_agg,
                  agg_vbias=(tuple(kw["discard_min"] for _, kw in aggs)
                             if o.get("vbias") else ()))
    nrec = np.full(B, 0 if o.get("unmatched") else C, np.int32)
    return fields, cols, nrec


def k11_case_expect(name: str, R: int, span: int, seg: dict) -> None:
    """Each K11 case reaches the edge it is named for (seg: K11's outputs,
    on any device; span: the kernel's range length)."""
    import torch
    gid = seg["gid"].to(torch.int64)
    ng = int(seg["num_groups"].item())
    nseg = int(gid[-1].item()) + 1
    longest = int(torch.bincount(gid).max().item())
    score = seg["score"]
    ok = {"a segment across more than 32 ranges": longest > 33 * span,
          "segments of a range's length": (
              nseg == -(-R // span) and longest == span),
          "every row its own segment": ng == nseg == R,
          "all rows unmatched": ng == 0 and nseg == 1,
          "R not a multiple of the range": R % span != 0 and ng > 1,
          "sums that wrap mod 2^64": bool((seg["sums"][:ng] < 0).any()),
          # a live segment's end scored -inf: more than the R - ng rows
          # that are no live end
          "acnt 0 under prune_agg": score.dtype == torch.float32 and int(
              (score == float("-inf")).sum().item()) > R - ng,
          "33 aggregations": seg["sums"].shape[1] == 2 + 3 * 33}[name]
    if not ok:
        fail(f"K11 case {name!r} misses its edge: {ng} live groups, {nseg} "
             f"segments, the longest {longest} rows, span {span}, R {R}")


def k11_edge_checks(card, device, errs) -> None:
    """K11 on the card over K11_CASES, after K7's enum form and the
    stable sort, each launch held to its plain version word for word
    (gid, sums, score, num_groups), by $COUNT and by the first
    aggregation's f32 mean.  Fails unless every path of scan.K11_PATHS
    ran (the kernel's own counts).  A call's device operations (1: one
    cooperative launch) are checked late."""
    import dataclasses

    import torch

    from sybil_tpu_torch.ops import scan
    total = dict.fromkeys(scan.K11_PATHS, 0)
    lines = []
    for name, o in K11_CASES.items():
        B, C = o.get("shape", (3, 65536))
        R = B * C
        span = scan.enum_ranges(device, R)[0]
        fields, ncols, nrec = k11_case(name, B, C, span)
        cfg = k2w_config(scan, fields)
        if scan.enum_radix(cfg) <= 0:
            fail(f"K11 case {name!r} is not enumerable")
        cols = {k: (torch.from_numpy(v).to(device),
                    torch.from_numpy(m).to(device))
                for k, (v, m) in ncols.items()}
        front = scan.sorted_front(cfg, cols, torch.from_numpy(nrec)
                                  .to(device))
        skey, p = torch.sort(front["key"], stable=True)
        forms = [cfg, dataclasses.replace(
            cfg, prune_agg=0 if cfg.prune_agg < 0 else -1)]
        for cf in forms:
            paths = torch.zeros(len(scan.K11_PATHS), dtype=torch.int64,
                                device=device)
            got = scan.enum_segments(cf, cols, skey, p, paths=paths)
            want = scan.enum_segments_plain(cf, cols, skey, p)
            check_outs("enum_segments", f"case {name!r} (prune_agg "
                       f"{cf.prune_agg})", got, want,
                       ("gid", "sums", "score", "num_groups"), errs)
            for k, n in zip(scan.K11_PATHS, paths.tolist()):
                total[k] += n
            if cf is cfg:
                k11_case_expect(name, R, span, got)
        lines.append(f"{name}: R {R}, span {span}, "
                     f"{int(got['num_groups'].item())} live groups")
        if name == "33 aggregations":
            LATE_OP_CHECKS.append((
                f"enum_segments ({name})", 1,
                lambda a=(cfg, cols, skey, p): scan.enum_segments(*a)))
    if not all(total.values()):
        fail(f"K11's paths {total}: each must run")
    say(f"[{card}] K11 == plain word for word on {len(K11_CASES)} corner "
        f"cases, $COUNT and f32 scores; paths {total}: " + "; ".join(lines))



# ---------------------------------------------------------------------------
# phase 4: count distinct (K13, K3's HLL sections, K7-K10's distinct
# pairs) and the kernels' former fixed caps (C1)
# ---------------------------------------------------------------------------

I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
# name -> options.  kind: "hll" (the dense strategy's device HLL), "pairs"
# (the sorted strategy's distinct pairs), "dense", "sorted" or "enum" (the
# C1 shapes); keys: [(min, card)] of the group keys (dense) or [(lo, hi)]
# of their values; dist: a str distinct column's dictionary size, "int"
# for an int column (HLL), or [(lo, hi)] of each distinct column (pairs);
# crafted: hash entries with rest == 0; time: (lo, hi, bucket); nrec;
# filters: how many int filters; aggs: how many aggregations (the first
# two histograms in the dense and sorted C1 shapes, tracked); extra:
# ScanConfig fields
DISTINCT_EDGES = {
    "HLL: int MISSING, negative, INT64_MIN and INT64_MAX values": dict(
        kind="hll", keys=[(0, 5)], dist="int"),
    "HLL: every row unmatched": dict(kind="hll", keys=[(0, 5)], dist=40,
                                     nrec=(0, 0, 0)),
    "HLL: more live slots than Phll": dict(kind="hll",
                                           keys=[(0, 4), (0, 5)],
                                           dist="int"),
    "HLL: crafted hashes with rest == 0": dict(kind="hll", keys=[(0, 3)],
                                               dist=30, crafted=True),
    "HLL: a dictionary past the pair form (rows)": dict(
        kind="hll", keys=[(0, 5)], dist=6000),
    "HLL: time-bucketed through K2's time key, filters": dict(
        kind="hll", keys=[(0, 3)], dist=25, time=(1000, 5000, 500),
        filters=2),
    "pairs: D = 2, MISSING and negative values": dict(
        kind="pairs", keys=[(0, 6), (-3, 3)], dist=[(0, 9), (-4, 4)]),
    "pairs: filters, a weight, a hist agg, past kmax_pairs": dict(
        kind="pairs", keys=[(0, 30)], dist=[(-50, 50)], filters=2, aggs=1,
        weight=True, extra=dict(max_pairs=64)),
    "pairs: every row unmatched": dict(kind="pairs", keys=[(0, 5)],
                                       dist=[(0, 9)], nrec=(0, 0, 0)),
    "C1: 17 filters, 33 aggregations (dense)": dict(
        kind="dense", keys=[(0, 5)], filters=17, aggs=33, weight=True),
    "C1: 17 keys, 17 filters, 33 aggregations (sorted)": dict(
        kind="sorted", keys=[(0, 3)] * 17, filters=17, aggs=33),
    "C1: 17 packed keys, 33 aggregations (enumerated)": dict(
        kind="enum", keys=[(0, 1)] * 17, aggs=33,
        extra=dict(prune_topk=100)),
    # past the 256 descriptor words a launch carries in its parameters
    # (csrc/desc.cuh): K2 above, K7, K8 and K11 here read the device copy
    "C1: 60 filters, 50 aggregations (sorted)": dict(
        kind="sorted", keys=[(0, 3)] * 2, filters=60, aggs=50),
    "C1: 60 aggregations (enumerated)": dict(
        kind="enum", keys=[(0, 1)] * 3, aggs=60,
        extra=dict(prune_topk=100)),
}


def distinct_edge(name: str, device, B: int = 3, C: int = 65536):
    """A synthetic batch of DISTINCT_EDGES -> (ScanConfig, cols, nrec,
    filter_vals, bitsets, time bucket)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops.scan import (HLL_P, AggSpec, FilterSpec,
                                          ScanConfig)
    o = DISTINCT_EDGES[name]
    kind = o["kind"]
    rng = np.random.default_rng(len(name) + 300)
    R = B * C
    cols = {}

    def put(col, v, p_valid):
        cols[col] = (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C))
                     .to(device),
                     torch.from_numpy((rng.random(R) < p_valid)
                                      .reshape(B, C)).to(device))

    groups, bounds = [], []
    tkw, tb = {}, 1
    if "time" in o:
        lo, hi, tb = o["time"]
        put("t", rng.integers(lo, hi, R), 0.95)
        tkw = dict(time_col="t")
        bounds.append((lo // tb, (hi - lo) // tb + 1))
    for i, (a, b) in enumerate(o["keys"]):
        # (min, card) bounds: values in [min, min + card); pairs: [lo, hi)
        hi = b if kind == "pairs" else a + b
        put(f"k{i}", rng.integers(a, hi, R), 0.9)
        groups.append(f"k{i}")
        bounds.append((a, b))
    bits, hidx, dist = (), -1, ()
    if kind == "hll":
        dist = ("d",)
        if o["dist"] == "int":
            put("d", np.where(rng.random(R) < 0.02, rng.choice(
                [I64_MIN, I64_MAX, -1, -7], R),
                rng.integers(-5000, 2_000_000, R)), 0.9)
        else:
            put("d", rng.integers(0, o["dist"], R), 0.9)
            hashes = rng.integers(0, 2 ** 63, o["dist"] + 1,
                                  dtype=np.uint64) * np.uint64(2)
            if o.get("crafted"):
                hashes[::3] = (np.arange(len(hashes[::3]), dtype=np.uint64)
                               << np.uint64(64 - HLL_P))
            bits = (torch.from_numpy(hashes.view(np.int64)).to(device),)
            hidx = 0
    elif kind == "pairs":
        for j, (lo, hi) in enumerate(o["dist"]):
            put(f"d{j}", rng.integers(lo, hi, R), 0.85)
        dist = tuple(f"d{j}" for j in range(len(o["dist"])))
    filters, fvals = [], []
    for i in range(o.get("filters", 0)):
        put(f"f{i}", rng.integers(0, 1000, R), 0.97)
        filters.append(FilterSpec(f"f{i}", "gt", "int"))
        fvals.append(i)
    aggs = []
    for a in range(o.get("aggs", 0)):
        put(f"v{a}", np.where(rng.random(R) < 0.03,
                              rng.integers(500, 3000, R),
                              rng.integers(-20, 400, R)), 0.85)
        hist = a < 2 and kind in ("dense", "sorted", "pairs")
        aggs.append(AggSpec(f"v{a}", hist_min=0, bucket_size=10 if hist
                            else 0, num_values=40 if hist else 0,
                            discard_min=-10, discard_max=2500))
    if o.get("weight"):
        put("w", rng.integers(0, 101, R), 0.8)
    kw = dict(tkw, **o.get("extra", {}))
    if kind in ("hll", "dense"):
        kw.update(key_bounds=tuple(bounds), track_outliers=kind == "dense")
    if kind == "hll":
        kw.update(hll=True, hll_hash_idx=hidx)
    if kind == "sorted":
        kw.update(force_sorted=True, track_outliers=True)
    if kind == "enum":
        kw.update(sort_pack=tuple(bounds))
    cfg = ScanConfig(group_cols=tuple(groups), aggs=tuple(aggs),
                     filters=tuple(filters), distinct_cols=dist,
                     weight_col="w" if o.get("weight") else "", **kw)
    nrec = torch.tensor(o.get("nrec", (C, 700, C - 3)), dtype=torch.int32,
                        device=device)
    return (cfg, cols, nrec, torch.tensor(fvals, dtype=torch.int64,
                                          device=device), bits, tb)


def distinct_edges_check(device, errs) -> list:
    """Every DISTINCT_EDGES batch through its strategy's kernels against
    their plain versions, each reaching the edge it is named for.
    -> one line per batch."""
    from sybil_tpu_torch.ops import scan
    lines = []
    for name, o in DISTINCT_EDGES.items():
        cfg, cols, nrec, fv, bits, tb = distinct_edge(name, device)
        B, C = next(iter(cols.values()))[0].shape
        R = B * C
        kind = o["kind"]
        want = {"hll": "dense", "dense": "dense", "pairs": "sorted",
                "sorted": "sorted", "enum": "sorted"}[kind]
        if cfg.strategy != want or (kind == "enum") != (
                scan.enum_radix(cfg) > 0):
            fail(f"distinct edge {name}: strategy {cfg.strategy}, enum "
                 f"radix {scan.enum_radix(cfg)}")
        if kind in ("hll", "dense"):
            _, main = scan_check(name, cfg, cols, nrec, errs, fv, bits, tb)
        elif kind == "enum":
            main, _, _ = enum_check(name, cfg, cols, nrec, errs, fv, bits)
        else:
            main, _, _ = sorted_check(name, cfg, cols, nrec, errs, fv, bits,
                                      tb)
        meta = main[0].tolist()
        H = len(scan.hist_aggs(cfg))
        layout = scan.packed_layout(cfg, R)
        ok = True
        if "every row unmatched" in name:
            ok = meta[0] == (0 if kind == "hll" else 1) and meta[2 + H] == 0
        elif "more live slots" in name:
            ok = meta[0] > layout["Phll"]
        elif "past kmax_pairs" in name or kind == "pairs":
            ok = meta[2 + H] > (layout["kmax_pairs"]
                                if "past kmax" in name else 0)
        elif "C1" in name:
            ok = (len(cfg.filters), len(cfg.aggs), cfg.n_key_cols) == (
                o.get("filters", 0), o["aggs"], len(o["keys"]))
        if not ok:
            fail(f"distinct edge {name}: meta {meta[:8 + 2 * H]} misses "
                 f"its edge")
        lines.append(f"{name}: groups {meta[0]}, npairs {meta[2 + H]}")
    return lines


def np_hash_int(v):
    """FNV-1a 64 over the 8 little-endian bytes of each int64, then
    splitmix64's finaliser, in numpy uint64 (the host HLL's int fast
    path, vectorised) -> uint64."""
    import numpy as np
    u = np.asarray(v, np.int64).view(np.uint64)
    h = np.full(u.shape, 0xcbf29ce484222325, np.uint64)
    with np.errstate(over="ignore"):
        for i in range(8):
            h = (h ^ ((u >> np.uint64(8 * i)) & np.uint64(0xFF))) * \
                np.uint64(0x100000001b3)
        h = h + np.uint64(0x9E3779B97F4A7C15)
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def numpy_hlls(gidx, ngroups: int, values, kind: str, strings=()):
    """A port HLL per group fed the numpy values of that group: int
    values by their hashes (np_hash_int, checked here against
    HLL.add's bytes on a sample), str values (dict ids into `strings`,
    -1 missing) by HLL.add of each distinct display string and the
    delimiter.  -> [HLL] * ngroups."""
    import numpy as np

    from sybil_tpu_torch.constants import GROUP_DELIMITER, MISSING_VALUE
    from sybil_tpu_torch.query.hll import HLL, hash64
    out = [HLL() for _ in range(ngroups)]
    if kind == "int":
        sample = np.asarray(values[:2000], np.int64)
        want = np.array([hash64((int(x) & MISSING_VALUE).to_bytes(
            8, "little")) for x in sample], dtype=np.uint64)
        if not np.array_equal(np_hash_int(sample), want):
            fail("np_hash_int differs from the host HLL's hash64")
        h = np_hash_int(values)
        order = np.argsort(gidx, kind="stable")
        starts = np.searchsorted(gidx[order], np.arange(ngroups + 1))
        for g in range(ngroups):
            out[g].add_hashes(h[order[starts[g]: starts[g + 1]]])
        return out
    pairs = np.unique(np.stack([gidx, values], 1), axis=0)
    for g, v in pairs.tolist():
        out[g].add(((strings[v] if v >= 0 else "") + GROUP_DELIMITER)
                   .encode())
    return out


def hll_check(card, label, qr, keys_of, hlls, regs: bool) -> int:
    """A query result's Distinct of each group against the numpy-fed
    HLLs (and, where the device HLL ran, its registers byte for byte).
    -> groups checked."""
    import numpy as np
    got = {keys_of(r): r for r in qr.results.values()}
    want = {g: h for g, h in enumerate(hlls) if h.registers.any()}
    if set(got) != set(want):
        fail(f"{label}: groups {sorted(got)} vs numpy {sorted(want)}")
    for g, h in want.items():
        d = got[g].distinct
        if d.cardinality() != h.cardinality():
            fail(f"{label} group {g}: Distinct {d.cardinality()} vs numpy "
                 f"{h.cardinality()}")
        if regs and not np.array_equal(d.registers, h.registers):
            fail(f"{label} group {g}: registers differ from numpy's")
    return len(want)


# ---------------------------------------------------------------------------
# set filters and samples: the sets table, K14, K2's and K7's set ops and
# matched mask, and S1-S5
# ---------------------------------------------------------------------------

# S1-S5 (query flags after -dir, -table): the set-filter and samples
# queries of the sets table
S_ARGV = {
    "S1": ["-group", "host", "-int", "ping", "-op", "avg", "-set-filter",
           "groups:in:mod3"],
    "S2": ["-group", "host", "-int", "ping", "-op", "avg", "-set-filter",
           "groups:nin:mod2", "-str-filter", "status:eq:200"],
    "S3": ["-group", "host,status", "-int", "ping", "-op", "hist",
           "-tdigest", "-set-filter", "groups:in:mod5"],
    "S4a": ["-samples", "-limit", "10", "-set-filter", "groups:in:mod3"],
    "S4b": ["-samples", "-limit", "10", "-sample-cols", "host,ping,groups",
            "-group", "host", "-int", "ping", "-op", "hist", "-tdigest"],
    "S5 in": ["-set-filter", "groups:in:nosuch"],
    "S5 nin": ["-set-filter", "groups:nin:nosuch"],
}


def uptime_set_columns(n: int, start_index: int):
    """scripts/fakedata/host_generator.py:columns (seed 1337 +
    start_index; the `groups` set holds mod2, mod3 and mod5 of index_int,
    or `none`), with its `now` fixed to bench.py's BENCH_NOW so the table
    does not depend on the clock.  -> (ints, strs, sets, status ids, host
    ids)."""
    import numpy as np
    rng = np.random.default_rng(BENCH_SEED + start_index)
    now = BENCH_NOW
    idx = np.arange(start_index, start_index + n, dtype=np.int64)
    ints = {
        "ping": np.abs(rng.normal(60, 20, n)).astype(np.int64),
        "weight": rng.choice([1, 10, 100], n).astype(np.int64),
        "time": now + rng.integers(-2419200, 2419200, n),
        "index_int": idx,
    }
    status = rng.integers(0, 5, n)
    host = rng.integers(0, 5, n)
    strs = {
        "status": [STATII[i] for i in status],
        "host": [HOSTS[i] for i in host],
        "index_str": [str(i) for i in idx],
    }
    sets = {"groups": [
        [g for m, g in ((2, "mod2"), (3, "mod3"), (5, "mod5"))
         if i % m == 0] or ["none"] for i in idx.tolist()]}
    return ints, strs, sets, status, host


def sets_flags(root: str):
    from sybil_tpu_torch.config import Flags
    return Flags(dir=root, table="uptime", skip_compact=True,
                 device_batch=1024)


def build_sets_table(root: str, n_rows: int):
    """The uptime table with `groups`, written by the port in 1M-row
    steps.  -> (Table, Flags, {"host", "status": list indices, "ping",
    "index_int"})."""
    import numpy as np

    from sybil_tpu_torch.table import Table
    flags = sets_flags(root)
    t = Table("uptime", flags)
    parts = {"host": [], "status": [], "ping": [], "index_int": []}
    for start in range(0, n_rows, STEP):
        n = min(STEP, n_rows - start)
        ints, strs, sets, status, host = uptime_set_columns(n, start)
        t.ingest_columns(ints=ints, strs=strs, sets=sets)
        parts["host"].append(host)
        parts["status"].append(status)
        parts["ping"].append(ints["ping"])
        parts["index_int"].append(ints["index_int"])
    return t, flags, {k: np.concatenate(v) for k, v in parts.items()}


def start_sets_table(root: str, n_rows: int):
    """build_sets_table in a process of its own, so that its host work (a
    distinct index_str a row through the dictionary, the longest of the
    builds) runs beside the other tables'; its arrays go to root + ".npz".
    -> the process, for join_sets_table."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, chip_smoke; "
            "chip_smoke.save_sets_table(sys.argv[1], int(sys.argv[2]))")
    return subprocess.Popen([sys.executable, "-c", code, root, str(n_rows)],
                            cwd=here)


def save_sets_table(root: str, n_rows: int) -> None:
    import numpy as np
    t0 = time.perf_counter()
    _, _, arr = build_sets_table(root, n_rows)
    np.savez(root + ".npz", **arr)
    say(f"built the sets table (uptime with groups): {n_rows} rows in "
        f"{time.perf_counter() - t0:.1f}s (host CPU, a process of its own)")


def join_sets_table(proc, root: str):
    """Wait for start_sets_table's process -> build_sets_table's
    (Table, Flags, arrays)."""
    import numpy as np

    from sybil_tpu_torch.table import Table
    if proc.wait() != 0:
        fail(f"the sets table's build exited {proc.returncode}")
    flags = sets_flags(root)
    t = Table("uptime", flags)
    t.load_info()
    with np.load(root + ".npz") as z:
        return t, flags, {k: z[k] for k in z.files}


def cli_query(table, argv, device="cuda"):
    """(Flags, QueryParams) of a query command line, as the CLI binds
    them."""
    from sybil_tpu_torch.cli import _flags_from_query_args, _query_parser
    from sybil_tpu_torch.query.spec import QueryParams
    f = _flags_from_query_args(_query_parser().parse_args(
        ["-dir", table.flags.dir, "-table", table.name, *argv,
         "-device", device]))
    return f, QueryParams.from_flags(f)


def set_edge_csrs(device, B: int = 3, C: int = 65536):
    """Synthetic batch CSRs for K14 -> [(label, prow, pval, n, R, filter
    constants)]: no entries, one row of 40 entries, entries in rows 0
    and R-1 only, a random CSR with duplicates read by two filters, an
    unknown literal."""
    import numpy as np
    import torch

    from sybil_tpu_torch.query.engine import pad_set_csr
    R = B * C
    rng = np.random.default_rng(4242)

    def csr(rows, vals):
        rows = np.asarray(rows, np.int64)
        prow, pval = pad_set_csr(rows, np.asarray(vals, np.int64), R)
        return (torch.from_numpy(prow).to(device),
                torch.from_numpy(pval).to(device), len(rows))

    k = rng.integers(0, 4, R)
    rows = np.repeat(np.arange(R), k)
    vals = rng.integers(0, 6, len(rows))
    out = [("empty CSR", *csr([], []), [3]),
           ("one row of 40 entries", *csr([77777] * 40, np.arange(40)),
            [17, 40]),
           ("rows 0 and R-1 only", *csr([0, 0, R - 1, R - 1], [5, 5, 5, 2]),
            [5, 2]),
           ("random rows, duplicates, two filters", *csr(rows, vals),
            [2, 4]),
           ("unknown literal", *csr(rows, vals), [-1])]
    return [(label, prow, pval, n, R,
             torch.tensor(f, dtype=torch.int64, device=device))
            for label, prow, pval, n, f in out]


def windowed_set_batch(device, B: int = 3, C: int = 65536):
    """A synthetic rollup batch for K2's windowed form with a set filter
    and the matched mask: 200 time quotients of 100 s, rows nearly
    time-sorted, 5% without the time column, a key k0 of 5 values, a
    set column s0.  -> (config, cols, nrec, filter constants, set_aux,
    bucket)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.query.engine import pad_set_csr
    R = B * C
    rng = np.random.default_rng(4343)
    t = np.sort(rng.integers(0, 20_000, R)) + rng.integers(-50, 50, R)
    cols = {}
    for name, v, p in (("t", t, 0.95), ("k0", rng.integers(0, 5, R), 0.9),
                       ("v0", rng.integers(0, 120, R), 0.85)):
        cols[name] = (torch.from_numpy(np.asarray(v, np.int64).reshape(
            B, C)).to(device), torch.from_numpy(
                (rng.random(R) < p).reshape(B, C)).to(device))
    k = rng.integers(0, 3, R)
    rows = np.repeat(np.arange(R), k)
    prow, pval = pad_set_csr(rows, rng.integers(0, 4, len(rows)), R)
    aux = {"s0": (torch.from_numpy(prow).to(device),
                  torch.from_numpy(pval).to(device), len(rows))}
    cfg = scan.ScanConfig(
        group_cols=("k0",),
        aggs=(scan.AggSpec("v0", hist_min=0, bucket_size=0, num_values=0,
                           discard_min=0, discard_max=100),),
        filters=(scan.FilterSpec("s0", "nin", "set"),),
        time_col="t", key_bounds=((-1, 202), (0, 5)), window=256,
        window_chunk=8192, want_matched_mask=True)
    if not scan.windowed(cfg):
        fail("the synthetic set rollup is not windowed")
    nrec = torch.tensor([C, C - 1000, 7], dtype=torch.int32, device=device)
    fv = torch.tensor([1], dtype=torch.int64, device=device)
    return cfg, cols, nrec, fv, aux, 100


def enum_set_batch(device, B: int = 3, C: int = 65536):
    """A synthetic enumerated batch with a set filter: a Zipf(1.3) key of
    300 values packed into one int32 key, prune_topk 50 by $COUNT, a
    str-like filter and an `in` over s0.  -> (config, cols, nrec, filter
    constants, set_aux)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.query.engine import pad_set_csr
    R = B * C
    rng = np.random.default_rng(4444)
    cols = {}
    for name, v, p in (("k0", (rng.zipf(1.3, R) - 1) % 300, 0.9),
                       ("v0", rng.integers(0, 90, R), 0.85),
                       ("fs", rng.integers(0, 10, R), 0.9)):
        cols[name] = (torch.from_numpy(np.asarray(v, np.int64).reshape(
            B, C)).to(device), torch.from_numpy(
                (rng.random(R) < p).reshape(B, C)).to(device))
    k = rng.integers(0, 3, R)
    rows = np.repeat(np.arange(R), k)
    prow, pval = pad_set_csr(rows, rng.integers(0, 3, len(rows)), R)
    aux = {"s0": (torch.from_numpy(prow).to(device),
                  torch.from_numpy(pval).to(device), len(rows))}
    cfg = scan.ScanConfig(
        group_cols=("k0",),
        aggs=(scan.AggSpec("v0", hist_min=0, bucket_size=0, num_values=0,
                           discard_min=0, discard_max=100),),
        filters=(scan.FilterSpec("fs", "neq", "str"),
                 scan.FilterSpec("s0", "in", "set")),
        key_bounds=((0, 300),), sort_pack=((0, 300),), prune_topk=50,
        prune_agg=-1, force_sorted=True)
    if scan.enum_radix(cfg) <= 0:
        fail("the synthetic set batch is not enumerable")
    nrec = torch.tensor([C, C - 300, C - 3], dtype=torch.int32,
                        device=device)
    fv = torch.tensor([4, 1], dtype=torch.int64, device=device)
    return cfg, cols, nrec, fv, aux


def sets_kernel_checks(card, table, flags, arr, C: int, device, errs):
    """K14 on the sets table's batch (every set value and an unknown
    literal; has and hit also against numpy) and on edge CSRs; K2's
    shared and global forms with S1's and S2's set filters and the
    matched mask, its windowed form on a synthetic rollup; K7's sorted
    form with S3's set filter, S4b's mask and both, its enum form with a
    set filter; each against its plain version, bit for bit.  -> the
    batch context for the main path and the timings."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.ops.residency import device_const
    from sybil_tpu_torch.query.engine import BatchLoader
    dirs = sorted(table.block_infos())
    infos = table.block_infos()
    B = len(dirs)
    R = B * C
    _, p1 = cli_query(table, S_ARGV["S1"])
    b1 = bound_query(table, dataclasses.replace(flags, device=str(device)),
                     p1)
    loader = BatchLoader(b1, dirs, C, {d: infos[d].num_records for d in dirs},
                         device)
    cols, nrec_np, set_aux = loader.load()
    nrec = torch.from_numpy(nrec_np).to(device)
    prow, pval, n = set_aux["groups"]
    idx = arr["index_int"]
    want_n = int(np.maximum((idx % 2 == 0).astype(np.int64)
                            + (idx % 3 == 0) + (idx % 5 == 0), 1).sum())
    if n != want_n or prow.numel() < n or prow.numel() & (prow.numel() - 1):
        fail(f"sets batch CSR: {n} entries in {prow.numel()}, numpy "
             f"{want_n}")
    # the batch's index_int, in the loader's block order, for numpy
    icols, _ = decoded_cols(table, ["index_int"], C, device)
    iv = icols["index_int"][0].reshape(-1).cpu().numpy()
    in_range = (np.arange(C)[None, :] < nrec_np[:, None]).reshape(-1)
    gd = table.dicts.get("groups")
    for name, m in (("mod2", 2), ("mod3", 3), ("mod5", 5), ("none", 0),
                    ("nosuch", -1)):
        fid = gd.lookup(name)
        fvt = torch.tensor([fid], dtype=torch.int64, device=device)
        has, hit = scan.set_match(prow, pval, n, fvt, 0, R)
        hp, tp = scan.set_match_plain(prow, pval, n, fvt, 0, R)
        check_equal(f"K14 sets batch {name} has", has, hp,
                    errs["set_match"])
        check_equal(f"K14 sets batch {name} hit", hit, tp,
                    errs["set_match"])
        hb = scan.unpack_row_bits(has, R).cpu().numpy()
        tb = scan.unpack_row_bits(hit, R).cpu().numpy()
        if m > 0:
            want = in_range & (iv % m == 0)
        elif m == 0:
            want = in_range & (iv % 2 != 0) & (iv % 3 != 0) & (iv % 5 != 0)
        else:
            want = np.zeros(R, bool)
        if not (np.array_equal(hb, in_range) and np.array_equal(tb, want)):
            fail(f"K14 sets batch {name}: has/hit differ from numpy")
    edges = set_edge_csrs(device)
    for label, eprow, epval, en, eR, efv in edges:
        for fi in range(efv.numel()):
            got = scan.set_match(eprow, epval, en, efv, fi, eR)
            want = scan.set_match_plain(eprow, epval, en, efv, fi, eR)
            for g, w, nm in zip(got, want, ("has", "hit")):
                check_equal(f"K14 {label} filter {fi} {nm}", g, w,
                            errs["set_match"])
    say(f"K14 set_match == plain (bit for bit) on the sets batch ({n} "
        f"entries in {prow.numel()}; mod2/mod3/mod5/none/unknown, has and "
        f"hit == numpy) and {len(edges)} edge CSRs: "
        + ", ".join(e[0] for e in edges))

    ctx = {"cols": cols, "nrec": nrec, "set_aux": set_aux, "B": B, "R": R,
           "dirs": dirs}
    for label in ("S1", "S2"):
        _, p = cli_query(table, S_ARGV[label])
        bq = bound_query(table, flags, p)
        fv = device_const(bq.filter_vals, device)
        sub = {k: cols[k] for k in ("host", "ping")}
        if label == "S2":
            sub["status"] = decoded_cols(table, ["status"], C, device)[0][
                "status"]
        for mask in (False, True):
            cfg = dataclasses.replace(bq.config, want_matched_mask=mask)
            forms = ["shared", "global"]
            k2, _ = scan_check(f"{label}{' + mask' if mask else ''}", cfg,
                               sub, nrec, errs, fv, set_aux=set_aux,
                               forms=forms)
        ctx[label] = (bq.config, sub, fv)
        say(f"K2/K14/K3 == plain: {label} with its set filter, with and "
            f"without the matched mask, forms {forms}")
    wcfg, wcols, wnrec, wfv, waux, wtb = windowed_set_batch(device)
    scan_check("synthetic set rollup + mask", wcfg, wcols, wnrec, errs,
               wfv, tb=wtb, set_aux=waux)
    say("K2 windowed and global forms == plain on a synthetic rollup with "
        "a set filter and the matched mask")
    # K7: S3 (a set filter), S4b (the mask), both
    _, p3 = cli_query(table, S_ARGV["S3"])
    b3 = bound_query(table, dataclasses.replace(flags, tdigest=True), p3)
    _, p4b = cli_query(table, S_ARGV["S4b"])
    b4b = bound_query(table, dataclasses.replace(flags, tdigest=True), p4b)
    status = decoded_cols(table, ["status"], C, device)[0]["status"]
    fv3 = device_const(b3.filter_vals, device)
    cols3 = {"host": cols["host"], "ping": cols["ping"], "status": status}
    for label, cfg, fv in (
            ("S3", b3.config, fv3),
            ("S4b", b4b.config, None),
            ("S3 + mask", dataclasses.replace(b3.config,
                                              want_matched_mask=True), fv3)):
        sub = {k: cols3[k] for k in ("host", "ping", "status")
               if k in cfg.group_cols or k in [a.col for a in cfg.aggs]}
        sorted_check(label, cfg, sub, nrec, errs, fv, set_aux=set_aux)
        ctx[label] = (cfg, sub, fv)
    say(f"K7 (sorted form), K14, sorts, K8-K10 == plain on S3 (a set filter, "
        f"{'packed' if scan.sort_packed(b3.config) else 'unpacked'} key), "
        f"S4b (the matched mask) and S3 with the mask")
    ecfg, ecols, enrec, efv, eaux = enum_set_batch(device)
    enum_check("synthetic enumerated batch with a set filter", ecfg, ecols,
               enrec, errs, efv, set_aux=eaux)
    say("K7's enum form, K11, K12, K10 == plain on a synthetic enumerated "
        "batch with a set filter")
    return ctx


def numpy_rows_of(table, bdir, rows, names):
    """Rows `rows` of block `bdir` as the port's blocks module reads them
    back: {column: value} of each present column (a set as its strings)."""
    from sybil_tpu_torch import blocks
    data = blocks.load_block_columns(bdir, table.schema, names)
    out = []
    for r in rows:
        row = {}
        for name, cd in data.items():
            if isinstance(cd, blocks.IntColumnData):
                if cd.valid[r]:
                    row[name] = int(cd.values[r])
            elif isinstance(cd, blocks.StrColumnData):
                if cd.valid[r]:
                    row[name] = table.dicts.get(name).strings[int(cd.ids[r])]
            else:
                lo, hi = int(cd.offsets[r]), int(cd.offsets[r + 1])
                if hi > lo:
                    strs = table.dicts.get(name).strings
                    row[name] = [strs[int(v)] for v in cd.values[lo:hi]]
        out.append(row)
    return out


def sets_main_path(card, table, arr, launches):
    """S1-S5 through the CLI (S5 through run_query) on cuda, cold from S1
    on, each against numpy over the generated columns; the samples of S4a
    and S4b against the first matched rows in block order, read back by
    the port's blocks module and checked against the generated columns;
    each run's launches added to `launches`."""
    import numpy as np

    from sybil_tpu_torch.ops import kernels, residency
    from sybil_tpu_torch.query.engine import run_query
    idx = arr["index_int"]
    hosts, status, ping = arr["host"], arr["status"], arr["ping"]
    nb = len(table.block_infos())
    N = len(idx)
    base = ["query", "-dir", table.flags.dir, "-table", "uptime", "-json",
            "-device-batch", str(nb), "-device", "cuda"]
    zero = {k: 0 for k in COUNTED}

    def run(label, expect):
        rc, out, wall, ll = run_cli(base + S_ARGV[label])
        if rc != 0:
            fail(f"{label}: port CLI query exited {rc}")
        if ll != dict(zero, **expect):
            fail(f"{label}: launches {ll}, expected {expect}")
        tally(launches, ll)
        return json.loads(out), wall, ll

    residency.CACHE.clear()
    for label, sel, expect in (
            ("S1", idx % 3 == 0, dict(decode_bucket2=2, set_match=1,
                                      dense_scan=1, dense_pack=1)),
            ("S2", (idx % 2 != 0) & (status == STATII.index("200")),
             dict(decode_bucket2=1, set_match=1, dense_scan=1,
                  dense_pack=1))):
        rows, wall, ll = run(label, expect)
        want = numpy_groupby(hosts[sel], ping[sel])
        got = {r["host"]: r for r in rows}
        if set(got) != set(want):
            fail(f"{label}: groups {sorted(got)} vs {sorted(want)}")
        for h, (cnt, s) in want.items():
            r = got[h]
            if r["Count"] != cnt or r["Samples"] != cnt or \
                    r["ping"] != s / cnt:
                fail(f"{label} group {h}: port {r} vs numpy count={cnt} "
                     f"sum={s}")
        say(f"main path: CLI {label} on cuda == numpy group-by "
            f"({len(want)} groups, {int(sel.sum())} of {N} rows); launches "
            f"{ll}; wall {wall:.3f}s")

    # S3: the sorted strategy with a set filter
    f3, p3 = cli_query(table, S_ARGV["S3"])
    b3 = bound_query(table, f3, p3)
    agg3 = b3.config.aggs[0]
    track3 = int(b3.config.track_outliers)
    rows, wall, ll = run("S3", dict(set_match=1, sorted_front=1,
                                    segment_reduce=1, hist_prep=1,
                                    hist_pairs=1, outlier_compact=track3,
                                    sorted_pack=1))
    sel = idx % 5 == 0
    keep = sel & (ping >= agg3.discard_min) & (ping <= agg3.discard_max)
    got = {(r["host"], r["status"]): r for r in rows}
    want_g = {}
    for g in np.unique(hosts[sel] * 5 + status[sel]).tolist():
        gsel = sel & (hosts * 5 + status == g)
        gkeep = keep & (hosts * 5 + status == g)
        edge = agg3.hist_min + (ping[gkeep] - agg3.hist_min) \
            // agg3.bucket_size * agg3.bucket_size
        vals, cnts = np.unique(edge, return_counts=True)
        want_g[(HOSTS[g // 5], STATII[g % 5])] = (
            int(gsel.sum()), int(gkeep.sum()),
            {(HOSTS[g // 5], int(v)): int(c)
             for v, c in zip(vals.tolist(), cnts.tolist())})
    if set(got) != set(want_g):
        fail(f"S3: groups {sorted(got)} vs {sorted(want_g)}")
    for k, (cnt, kept, pairs) in want_g.items():
        r = got[k]
        if r["Count"] != cnt or r["Samples"] != cnt or \
                r["ping"]["samples"] != kept:
            fail(f"S3 group {k}: port {r['Count']}/{r['ping']['samples']} "
                 f"vs numpy {cnt}/{kept}")
        if r["ping"]["percentiles"] != numpy_tdigest_percentiles(
                pairs, k[0], agg3):
            fail(f"S3 group {k}: percentiles differ from a t-digest of "
                 f"numpy's pairs")
    say(f"main path: CLI S3 (sorted, a set filter) on cuda == numpy "
        f"({len(got)} (host, status) groups: count, kept rows, percentiles "
        f"of a t-digest of numpy's pairs); launches {ll}; wall {wall:.3f}s")

    # S4a (dense, K2's mask) and S4b (sorted, K7's mask): the samples are
    # the first matched rows in block order
    f4b, p4b = cli_query(table, S_ARGV["S4b"])
    track4b = int(bound_query(table, f4b, p4b).config.track_outliers)
    first = list(table.block_infos())[0]
    all_cols = sorted(table.schema.key_table)
    for label, sel, names, expect in (
            ("S4a", idx % 3 == 0, all_cols,
             dict(set_match=1, dense_scan=1, dense_pack=1)),
            ("S4b", np.ones(N, bool), ["host", "ping", "groups"],
             dict(sorted_front=1, segment_reduce=1, hist_prep=1,
                  hist_pairs=1, outlier_compact=track4b, sorted_pack=1))):
        rows, wall, ll = run(label, expect)
        from sybil_tpu_torch import blocks
        bidx = blocks.load_block_columns(first, table.schema,
                                         ["index_int"])["index_int"].values
        brows = [r for r in range(len(bidx))
                 if sel[int(bidx[r])]][:10]
        want = numpy_rows_of(table, first, brows, names)
        if rows != want:
            fail(f"{label}: the samples are not the first matched rows of "
                 f"the first block")
        for r, w in zip(rows, [int(bidx[i]) for i in brows]):
            if r["host"] != HOSTS[hosts[w]] or r["ping"] != int(ping[w]) \
                    or ("index_int" in r and r["index_int"] != w):
                fail(f"{label}: sample {r} differs from the generated row "
                     f"{w}")
            if r["groups"] != ([g for m, g in ((2, "mod2"), (3, "mod3"),
                                               (5, "mod5")) if w % m == 0]
                               or ["none"]):
                fail(f"{label}: sample {r} has the wrong groups")
        say(f"main path: CLI {label} on cuda: {len(rows)} samples == the "
            f"first matched rows of the first block (index_int "
            f"{[int(bidx[i]) for i in brows]}); launches {ll}; wall "
            f"{wall:.3f}s")
    # S5: an unknown literal, through run_query
    for label, want_n in (("S5 in", 0), ("S5 nin", N)):
        f5, p5 = cli_query(table, S_ARGV[label] + ["-device-batch", str(nb)])
        kernels.reset_launches()
        qr = run_query(table, p5, f5)
        ll = kernels.snapshot()
        if ll != dict(zero, set_match=1, dense_scan=1, dense_pack=1):
            fail(f"{label}: launches {ll}")
        if qr.matched_count != want_n or qr.cumulative.count != want_n:
            fail(f"{label}: {qr.matched_count} rows, numpy {want_n}")
        tally(launches, ll)
        say(f"main path: {label} (groups:{label.split()[1]}:nosuch) on "
            f"cuda: {want_n} rows == numpy; launches {ll}")


def sets_timed(card, table, arr, rows: int, B: int):
    """S1 cold and warm (medians of 5, rows/s, the batch pipeline); the
    phase lines of S2-S4b."""
    from sybil_tpu_torch.ops import residency
    from sybil_tpu_torch.query.engine import run_query
    f1, p1 = cli_query(table, S_ARGV["S1"])
    qr = timed_queries(card, "S1 (groups:in:mod3)", table, p1,
                       dataclasses.replace(f1, device_batch=B), rows, B,
                       {"set_match": 1, "dense_scan": 1, "dense_pack": 1})
    sel = arr["index_int"] % 3 == 0
    want = numpy_groupby(arr["host"][sel], arr["ping"][sel])
    for h, (cnt, s) in want.items():
        r = qr.results[h + "\t"]
        if r.count != cnt or r.hists["ping"].avg != s / cnt:
            fail(f"S1 warm query group {h} differs from numpy")
    for label in ("S2", "S3", "S4a", "S4b"):
        f, p = cli_query(table, S_ARGV[label])
        f = dataclasses.replace(f, device_batch=B)
        phase_lines(card, label, lambda: run_query(table, p, f),
                    residency.CACHE.clear)


def sets_kernel_times(card, ctx, device):
    """K14 on S1's batch beside its plain version and the reference's own
    formula in torch (two index_add_ passes); K2 at S1's shape with the
    set filter and the mask against the same call without them; K7 at
    S3's shape with the set filter, S4b's with the mask.  -> kernel table
    rows (name, shape, replaces, ms, plain ms, bytes, int ops, library
    ms)."""
    import torch

    from sybil_tpu_torch.ops import scan
    cols, nrec, set_aux, R = ctx["cols"], ctx["nrec"], ctx["set_aux"], \
        ctx["R"]
    B = ctx["B"]
    prow, pval, n = set_aux["groups"]
    cfg1, sub1, fv1 = ctx["S1"]
    W = scan.mask_words(R)
    out = []
    ms = cuda_ms(lambda: scan.set_match(prow, pval, n, fv1, 0, R))
    pms = cuda_ms(lambda: scan.set_match_plain(prow, pval, n, fv1, 0, R),
                  iters=5)
    rows64 = prow.to(torch.int64)
    ones = torch.ones(prow.shape, dtype=torch.int32, device=device)

    def lib_call():
        hit = torch.zeros(R + 1, dtype=torch.int32, device=device)
        hit.index_add_(0, rows64, (pval == fv1[0]).to(torch.int32))
        has = torch.zeros(R + 1, dtype=torch.int32, device=device)
        has.index_add_(0, rows64, ones)
        return has, hit
    lib = cuda_ms(lib_call, iters=5)
    # the n real entries read once (4 B row id, 8 B value), both masks
    # written; per entry the compare and the bit (shift, or)
    out.append(("set_match", f"S1 groups:in:mod3 ({n} entries, R {R})",
                "sybil_tpu/ops/scan.py:376", ms, pms, n * 12 + 2 * W * 4,
                n * 4, lib))
    say(f"[{card}] set_match S1: {ms:.4f} ms (plain {pms:.4f} ms; two "
        f"index_add_ {lib:.4f} ms)")
    del rows64, ones
    sm1 = scan.set_filter_masks(cfg1, fv1, set_aux, R)
    cfg1m = dataclasses.replace(cfg1, want_matched_mask=True)
    cfg1n = dataclasses.replace(cfg1, filters=(), want_matched_mask=False)
    nofv = torch.zeros(0, dtype=torch.int64, device=device)
    # the same call: parent shape, change shape, change shape, parent
    t_plain, t_set = [], []
    for _ in range(2):
        t_plain.append(cuda_ms(lambda: scan.dense_scan(cfg1n, sub1, nrec,
                                                       nofv)))
        t_set.append(cuda_ms(lambda: scan.dense_scan(cfg1m, sub1, nrec, fv1,
                                                     set_masks=sm1)))
    pms = cuda_ms(lambda: scan.dense_scan_plain(cfg1m, sub1, nrec, fv1,
                                                set_masks=sm1), iters=5)
    Sc = scan.reduce_space(cfg1)[1]
    L = 2 + 3 * len(cfg1.aggs)
    base_bytes = len(sub1) * R * 9 + B * 4 + Sc * L * 8 + 8
    gid = scan.dense_scan(dataclasses.replace(cfg1m, aggs=(
        dataclasses.replace(cfg1.aggs[0], num_values=1, bucket_size=1),)),
        sub1, nrec, fv1, set_masks=sm1)["gid"].to(torch.int64)
    lanes = torch.ones((R, L), dtype=torch.int64, device=device)
    lib = cuda_ms(lambda: torch.zeros((Sc, L), dtype=torch.int64,
                                      device=device).index_add_(0, gid,
                                                                lanes),
                  iters=5)
    del lanes, gid
    ops = R * (6 + 8 * len(cfg1.group_cols) + 12 * len(cfg1.aggs) + 2)
    out.append(("dense_scan", "S1: a set filter and the matched mask",
                "sybil_tpu/ops/scan.py:1062", min(t_set), pms,
                base_bytes + 2 * W * 4 + R, ops + R * 4, lib))
    say(f"[{card}] dense_scan S1 shape: without a set filter and the mask "
        f"{t_plain} ms, with both {t_set} ms (alternating, min "
        f"{min(t_plain):.4f} / {min(t_set):.4f})")
    for label, rep in (("S3", "sybil_tpu/ops/scan.py:376"),
                       ("S4b", "sybil_tpu/ops/scan.py:1273")):
        cfg, sub, fv = ctx[label]
        sm = scan.set_filter_masks(cfg, fv, set_aux, R)
        bare = dataclasses.replace(cfg, filters=(), want_matched_mask=False)
        ms = cuda_ms(lambda: scan.sorted_front(cfg, sub, nrec, fv,
                                               set_masks=sm))
        ms0 = cuda_ms(lambda: scan.sorted_front(bare, sub, nrec))
        pms = cuda_ms(lambda: scan.sorted_front_plain(cfg, sub, nrec, fv,
                                                      set_masks=sm), iters=5)
        keyb = 4 if scan.pack_sentinel(cfg)[1] == torch.int32 else 8
        nk = len([k for k in sub if k in cfg.group_cols])
        nbytes = (nk * R * 9 + B * 4 + R * (4 + keyb)
                  + (2 * W * 4 if cfg.filters else 0)
                  + (R if cfg.want_matched_mask else 0))
        what = ("S3: a set filter" if label == "S3"
                else "S4b: the matched mask")
        out.append(("sorted_front", what, rep, ms, pms, nbytes,
                    R * (6 + 8 * nk + 4), None))
        say(f"[{card}] sorted_front {label}: {ms:.4f} ms, without "
            f"{'the set filter' if label == 'S3' else 'the mask'} "
            f"{ms0:.4f} ms (plain {pms:.4f} ms)")
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sort_bound_ms(R: int, key_bytes: int) -> float:
    """The least time of a stable torch.sort of R keys of key_bytes with
    its int64 indices (CUB's LSD radix sort): the index array written
    once, then one pass per 8 bits of key (4 for int32, 8 for int64), each
    reading and writing the key and the index; bytes / 3.35 TB/s."""
    passes = key_bytes
    return R * (8 + passes * 2 * (key_bytes + 8)) / HBM_BYTES_PER_S * 1e3


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def run_cli(argv):
    """The port's CLI in-process with the launch counts reset just before
    and read just after -> (rc, stdout, wall s, launches)."""
    from sybil_tpu_torch import cli
    from sybil_tpu_torch.ops import kernels
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    return rc, buf.getvalue(), wall, kernels.snapshot()


def snapshot(qr):
    """Everything a query result holds, histograms included."""
    import numpy as np
    rows = {}
    for k, r in qr.results.items():
        hs = {}
        for c, h in r.hists.items():
            if hasattr(h, "td"):
                # a t-digest's centroids, and so its percentiles and its
                # running mean, depend on how the pairs were batched: only
                # its counts are exact
                hs[c] = (h.count, h.samples)
                continue
            hs[c] = (h.count, h.avg, h.min, h.max,
                     tuple(np.asarray(getattr(h, "values", ())).tolist()),
                     tuple(getattr(h, "outliers", ()) or ()),
                     tuple(h.get_percentiles()) if h.percentile_mode
                     else ())
        rows[k] = (r.count, r.samples, hs)
    return rows, qr.cumulative.count, qr.matched_count


def phase_lines(card, label, run, clear):
    """The engine's phase timer line of one cold and one warm query."""
    from sybil_tpu_torch import debug as dbg
    for kind in ("cold", "warm"):
        if kind == "cold":
            clear()
        err = io.StringIO()
        dbg.DEBUG_FLAG = True
        with contextlib.redirect_stderr(err):
            run()
        dbg.DEBUG_FLAG = False
        line = [x for x in err.getvalue().splitlines()
                if "QUERY TIMING" in x][-1]
        say(f"[{card}] {label} {kind} query phases: "
            + line.split("QUERY TIMING ", 1)[1])


def timed_queries(card, label, table, params, qflags, rows, B, expect):
    """Cold and warm walls (median of 5), no decode when warm, and a
    three-batch pipeline equal to the one-batch query.  expect: kernel ->
    launches per batch of a warm query.  -> the last warm result."""
    import torch

    from sybil_tpu_torch.ops import kernels, residency
    from sybil_tpu_torch.query.engine import run_query
    table.load_info()
    cold = []
    for _ in range(5):
        residency.CACHE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_query(table, params, qflags)
        cold.append(time.perf_counter() - t0)
    kernels.reset_launches()
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        qr = run_query(table, params, qflags)
        warm.append(time.perf_counter() - t0)
    wl = kernels.snapshot()
    if wl["decode_bucket2"] != 0 or wl["decode_value"] != 0:
        fail(f"{label}: warm queries ran a decode kernel: {wl}")
    for k, n in expect.items():
        if wl[k] != 5 * n:
            fail(f"{label}: warm queries: expected {k} {n}x per batch: {wl}")
    if B > 2:
        nb = -(-B // 3)
        nbatch = -(-B // nb)
        kernels.reset_launches()
        multi = run_query(table, params, dataclasses.replace(
            qflags, device_batch=nb))
        ml = kernels.snapshot()
        for k, n in expect.items():
            if ml[k] != nbatch * n:
                fail(f"{label}: {nbatch}-batch query: expected {k} {n}x "
                     f"per batch: {ml}")
        if snapshot(multi) != snapshot(qr):
            fail(f"{label}: the {nbatch}-batch query differs from the "
                 f"one-batch query")
        say(f"{label}: {nbatch}-batch query (device_batch={nb}) == "
            f"one-batch query; launches {ml}")
    say(f"[{card}] {label} cold query wall median of 5: "
        f"{median(cold) * 1e3:.3f} ms ({rows / median(cold):.0f} rows/s); "
        f"walls {[round(x * 1e3, 3) for x in cold]}")
    say(f"[{card}] {label} warm query wall median of 5: "
        f"{median(warm) * 1e3:.3f} ms ({rows / median(warm):.0f} rows/s); "
        f"walls {[round(x * 1e3, 3) for x in warm]}; warm launches {wl}")
    phase_lines(card, label, lambda: run_query(table, params, qflags),
                residency.CACHE.clear)
    return qr


def check_hist_json(label, rows, agg, want, keys_of, group_cols):
    """The CLI's -json rows of a histogram query against numpy_hist."""
    got = {tuple(r[g] for g in group_cols): r for r in rows}
    expect = {keys_of(g): w for g, w in enumerate(want) if w["count"]}
    if set(got) != set(expect):
        fail(f"{label}: groups differ: {sorted(got)} vs {sorted(expect)}")
    col = agg.col
    nout = 0
    for k, w in expect.items():
        r = got[k]
        h = r[col]
        if (r["Count"] != w["count"] or r["Samples"] != w["count"]
                or h["samples"] != w["n"] or h["avg"] != w["sum"] / w["n"]):
            fail(f"{label} group {k}: port Count={r['Count']} "
                 f"samples={h['samples']} avg={h['avg']} vs numpy "
                 f"count={w['count']} n={w['n']} sum={w['sum']}")
        if h["buckets"] != str_buckets(agg, w["values"], w["outliers"]):
            fail(f"{label} group {k}: bucket counts differ from numpy")
        if len(h["percentiles"]) != 100:
            fail(f"{label} group {k}: {len(h['percentiles'])} percentiles")
        nout += len(w["outliers"])
    return len(expect), nout


# ---------------------------------------------------------------------------
# the query cache (-cache-queries) and the cache-group key
# ---------------------------------------------------------------------------

# scripts/bench_cache.py:35-95, the reference's sweep
# (scripts/test_cache_results.py:29-47): 15 shapes over the uptime table,
# each uncached, as a cache write and as a cache hit; then two shapes off
# the sweep for the sorted strategy (K7, K8) and tracked outliers (K5)
CACHE_SWEEP = ("count", "avg", "hist", "time_avg", "group", "distinct",
               "time_distinct", "group_avg", "group_avg_lim", "group_hist",
               "re_filter", "group2", "group2_avg", "time_group_10",
               "time_group_100")
CACHE_EXTRA = ("group_tdigest", "group_loghist")
CACHE_TB = 21600                 # bench_cache.py:56
CACHE_SPAN = 16                  # query/cache.py GROUP_SIZE


def cache_params(kind):
    """bench_cache.py:build_params, with the port's QueryParams."""
    from sybil_tpu_torch.query.spec import AggDef, FilterDef, QueryParams
    tb = dict(time_bucket=CACHE_TB, time_col="time")
    avg = (AggDef("ping", "avg"),)
    return {
        "count": QueryParams(),
        "avg": QueryParams(aggs=avg),
        "hist": QueryParams(aggs=(AggDef("ping", "hist"),)),
        "time_avg": QueryParams(aggs=avg, **tb),
        "group": QueryParams(groups=("host",)),
        "distinct": QueryParams(distincts=("host",)),
        "time_distinct": QueryParams(distincts=("host",), **tb),
        "group_avg": QueryParams(groups=("host",), aggs=avg),
        "group_avg_lim": QueryParams(groups=("host",), aggs=avg, limit=10),
        "group_hist": QueryParams(groups=("host",),
                                  aggs=(AggDef("ping", "hist"),)),
        "re_filter": QueryParams(aggs=avg, filters=(
            FilterDef("host", "re", "facebook|google", "str"),)),
        "group2": QueryParams(groups=("host", "status")),
        "group2_avg": QueryParams(groups=("host", "status"), aggs=avg),
        "time_group_10": QueryParams(groups=("host",), aggs=avg, limit=10,
                                     **tb),
        "time_group_100": QueryParams(groups=("host",), aggs=avg, limit=100,
                                      **tb),
        "group_tdigest": QueryParams(groups=("host",), aggs=(
            AggDef("ping", "hist", "tdigest"),)),
        "group_loghist": QueryParams(groups=("host",), aggs=(
            AggDef("ping", "hist", "multi"),)),
    }[kind]


def cache_snapshot(qr):
    """snapshot() with each group's distinct count and every time row."""
    rows = snapshot(qr)
    dist = {k: r.distinct.cardinality() for k, r in qr.results.items()
            if r.distinct is not None}
    trows = {}
    for tb, rs in qr.time_results.items():
        for gk, r in rs.items():
            trows[(tb, gk)] = (
                r.count, r.samples,
                {c: (h.count, h.avg) for c, h in r.hists.items()},
                r.distinct.cardinality() if r.distinct is not None else None)
    return rows, dist, trows


def cache_edge_batch(device, B: int = 64, C: int = 8192):
    """A synthetic batch of four 16-block cache groups: the third group's
    last eight blocks and all of the fourth are padding (nrec 0), as
    _scan_cache_vgroups pads a partial group and a power-of-two group
    count; key g with MISSING rows, value v past a 5-bucket hist (live
    outliers), time t sorted within each block (narrow windows)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(4242)
    R = B * C

    def col(v, p):
        return (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C)).to(
                    device),
                torch.from_numpy(rng.random(R) < p).reshape(B, C).to(device))

    t = np.sort(rng.integers(0, 3000, (B, C)), axis=1) + \
        np.arange(B)[:, None] * 3000
    cols = {"g": col(rng.integers(0, 7, R), 0.9),
            "v": col(rng.integers(0, 1000, R), 0.95),
            "t": col(t.reshape(-1), 0.97)}
    nrec = np.full(B, C, np.int32)
    nrec[40:] = 0
    nrec[5] = C - 77
    return cols, torch.from_numpy(nrec).to(device)


def cache_edge_configs():
    """The synthetic batch's cache-group configs (four groups)."""
    from sybil_tpu_torch.ops import scan
    ngp = 4
    avg = scan.AggSpec("v", 0, 0, 0, 0, 1000)
    hist = scan.AggSpec("v", 0, 100, 5, 0, 1000)
    cg = ("__cg__", "g")
    base = dict(filters=(), vg_span=CACHE_SPAN)
    qmax = 64 * 3000 // 500
    return {
        # vg_first: [cg, time, g] under a narrow window, both K2 forms
        "vg_first windowed rollup, padding groups": scan.ScanConfig(
            group_cols=cg, aggs=(avg,), time_col="t", time_i32=True,
            key_bounds=((0, ngp), (0, qmax), (0, 7)), window=64, **base),
        "vg_first rollup, int64 time, tracked outliers": scan.ScanConfig(
            group_cols=cg, aggs=(hist,), time_col="t", track_outliers=True,
            key_bounds=((0, ngp), (0, qmax), (0, 7)), **base),
        "[cg, g], tracked outliers past the packed section": scan.ScanConfig(
            group_cols=cg, aggs=(hist,), track_outliers=True, max_out=64,
            key_bounds=((0, ngp), (0, 7)), **base),
        "[cg, g], a spilled key bound": scan.ScanConfig(
            group_cols=cg, aggs=(avg,), key_bounds=((0, ngp), (0, 4)),
            **base),
        "[cg] alone, global form": scan.ScanConfig(
            group_cols=("__cg__",), aggs=(avg, hist), key_bounds=((0, ngp),),
            **base),
        "sorted [cg, time, g], hist outliers": scan.ScanConfig(
            group_cols=cg, aggs=(hist,), time_col="t", track_outliers=True,
            force_sorted=True, **base),
        "sorted packed [cg, g], a spill": scan.ScanConfig(
            group_cols=cg, aggs=(avg,), force_sorted=True,
            sort_pack=((0, ngp), (0, 4)), **base),
    }


def cache_edge_checks(device, errs) -> list:
    """K2 (its forms), K4, K5, K3, K7, sort_permute, K8, K9 and K10 with
    the cache-group key against their plain versions on the synthetic
    batch.  -> the labels checked."""
    from sybil_tpu_torch.ops import scan
    cols, nrec = cache_edge_batch(device)
    done = []
    for label, cfg in cache_edge_configs().items():
        if cfg.strategy == "sorted":
            main, _, _ = sorted_check(f"cache edge {label}", cfg, cols, nrec,
                                      errs, tb=500)
        else:
            forms = (["windowed", "global"] if scan.windowed(cfg) else
                     ["shared", "global"] if scan.dense_scan_path(cfg)
                     == "shared" else ["global"])
            _, main = scan_check(f"cache edge {label}", cfg, cols, nrec,
                                 errs, tb=500, forms=forms)
        spill = int(main[0, 1].item())
        if ("spill" in label) != (spill > 0):
            fail(f"cache edge {label}: spill count {spill}")
        done.append(label)
    return done


def cache_check_captured(captured, errs) -> list:
    """The kernels at the sweep's own vgroup shapes (the inputs the
    engine's cache writes handed scan_packed) against their plain
    versions: K2 in each form that applies, K13, K4, K5, K3; K7, the
    sorts, K8, K9, K5 over kmat, K10."""
    from sybil_tpu_torch.ops import scan
    out = []
    for kind, (cfg, cols, nrec, fv, bits, tb, set_aux) in captured.items():
        ngp = cfg.key_bounds[0][1] if cfg.key_bounds else 0
        what = f"cache {kind} (ngp {ngp})"
        if cfg.strategy == "sorted":
            sorted_check(what, cfg, cols, nrec, errs, fv, bits, tb, set_aux)
        else:
            forms = (["windowed", "global"] if scan.windowed(cfg) else
                     ["shared", "global"] if scan.dense_scan_path(cfg)
                     == "shared" else ["global"])
            scan_check(what, cfg, cols, nrec, errs, fv, bits, tb, set_aux,
                       forms=forms)
        out.append(f"{kind}: {cfg.strategy}"
                   + (f", K2 {'/'.join(forms)}" if cfg.strategy == "dense"
                      else ""))
    return out


def cache_phase(card, root, table, up, errs, launches, device):
    """The query cache on a copy of the uptime table through run_query
    (and the CLI once): each sweep shape uncached, as a write on an empty
    cache directory and as a hit, write and hit equal to the uncached
    answer (group_avg also to numpy); every group hits on the hit run,
    which launches no kernel; group_avg at device_batch 16 (one group a
    dispatch); 16 more full blocks appended: every old group hits and the
    new one misses.  Then the kernels at the captured vgroup shapes and
    on synthetic batches against their plain versions, the sweep's
    walls, phase lines, and K2 with and without the cache-group key.
    Launches of the write and hit runs are added to `launches`.
    -> the kernel table's rows."""
    import numpy as np
    import torch

    from sybil_tpu_torch import debug as dbg
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.ops import kernels, scan
    from sybil_tpu_torch.query import cache as qcache
    from sybil_tpu_torch.query.engine import run_query
    from sybil_tpu_torch.table import Table

    t0 = time.perf_counter()
    croot = os.path.join(root, "cache_up")
    shutil.copytree(os.path.join(table.flags.dir, "uptime"),
                    os.path.join(croot, "uptime"))
    flags = Flags(dir=croot, table="uptime", skip_compact=True,
                  device=device.type, device_batch=1024)
    cflags = dataclasses.replace(flags, cache_queries=True)
    ctab = Table("uptime", flags)
    cdir = os.path.join(croot, "uptime", qcache.constants.CACHE_DIR)
    infos = ctab.block_infos()
    groups, rest = qcache.stable_groups(list(infos), infos)
    ng = len(groups)
    if ng < 1:
        fail(f"cache phase: {len(infos)} blocks hold no cache group")
    say(f"cache phase: a copy of the uptime table ({len(infos)} blocks, "
        f"{ng} cache groups of {qcache.GROUP_SIZE}, {len(rest)} blocks "
        f"outside them) in {time.perf_counter() - t0:.1f}s")

    def qfiles():
        # the query cache's files; cache/ also holds the block-info cache
        return ([f for f in os.listdir(cdir) if f.startswith("q_")]
                if os.path.isdir(cdir) else [])

    def clear():
        for f in qfiles():
            os.remove(os.path.join(cdir, f))

    captured = {}
    state = {"kind": None}
    real = scan.scan_packed

    def spy(cfg, cols, nrec, fv=None, bits=(), tb=1, set_aux=None):
        kind = state["kind"]
        if kind and scan.has_cg(cfg) and kind not in captured:
            captured[kind] = (cfg, cols, nrec, fv, bits, tb, set_aux)
        return real(cfg, cols, nrec, fv, bits, tb, set_aux)

    def nonzero(ll):
        return {k: v for k, v in ll.items() if v}

    want = numpy_groupby(up["host"], up["ping"])
    uncached = {}
    t0 = time.perf_counter()
    for kind in CACHE_SWEEP + CACHE_EXTRA:
        params = cache_params(kind)
        run_query(ctab, params, flags)          # decoded columns resident
        qr_u = run_query(ctab, params, flags)
        su = cache_snapshot(qr_u)
        uncached[kind] = su
        clear()
        m0 = qcache.MISSES
        state["kind"] = kind
        scan.scan_packed = spy
        kernels.reset_launches()
        try:
            qr_w = run_query(ctab, params, cflags)
        finally:
            lw = kernels.snapshot()
            scan.scan_packed = real
            state["kind"] = None
        if qcache.MISSES - m0 != ng or len(qfiles()) != ng:
            fail(f"cache {kind}: the write missed {qcache.MISSES - m0} "
                 f"groups and wrote {len(qfiles())} files, not {ng}")
        h0, m0 = qcache.HITS, qcache.MISSES
        kernels.reset_launches()
        qr_h = run_query(ctab, params, cflags)
        lh = kernels.snapshot()
        if (qcache.HITS - h0, qcache.MISSES - m0) != (ng, 0):
            fail(f"cache {kind}: the hit run hit {qcache.HITS - h0} and "
                 f"missed {qcache.MISSES - m0} of {ng} groups")
        if not rest and any(lh.values()):
            fail(f"cache {kind}: a query whose groups all hit launched "
                 f"kernels: {nonzero(lh)}")
        if cache_snapshot(qr_w) != su:
            fail(f"cache {kind}: the write's answer differs from the "
                 f"uncached one")
        if cache_snapshot(qr_h) != su:
            fail(f"cache {kind}: the hit's answer differs from the uncached "
                 f"one")
        if kind == "group_avg":
            for h, (cnt, s) in want.items():
                for qr in (qr_w, qr_h):
                    r = qr.results[h + "\t"]
                    if r.count != cnt or r.hists["ping"].avg != s / cnt:
                        fail(f"cache group_avg group {h} differs from "
                             f"numpy")
        if kind not in captured:
            fail(f"cache {kind}: no cache-group scan ran")
        tally(launches, lw, lh)
        cfg = captured[kind][0]
        say(f"cache {kind}: write and hit == uncached ({len(qr_u.results)} "
            f"groups, {qr_u.matched_count} rows); {cfg.strategy} strategy, "
            f"ngp {cfg.key_bounds[0][1]}; launches: write {nonzero(lw)}, hit "
            f"{nonzero(lh)}")
    say(f"cache sweep: {len(CACHE_SWEEP)} of {len(CACHE_SWEEP)} shapes (and "
        f"{len(CACHE_EXTRA)} more) equal their uncached answers written "
        f"and hit, {ng} of {ng} groups hit, no kernel on an all-hit query "
        f"({time.perf_counter() - t0:.1f}s)")

    # the CLI's -cache-queries, written then hit, against numpy
    clear()
    argv = ["query", "-dir", croot, "-table", "uptime", "-group", "host",
            "-int", "ping", "-op", "avg", "-json", "-cache-queries",
            "-device-batch", "1024", "-device", device.type]
    for run in ("write", "hit"):
        rc, out, wall, ll = run_cli(argv)
        if rc != 0:
            fail(f"cache CLI {run}: exit {rc}")
        got = {r["host"]: r for r in json.loads(out)}
        for h, (cnt, s) in want.items():
            r = got[h]
            if r["Count"] != cnt or r["ping"] != s / cnt:
                fail(f"cache CLI {run} group {h}: {r} vs numpy {cnt}, {s}")
        tally(launches, ll)
        say(f"main path: CLI -cache-queries group by host avg ping, the "
            f"{run}, == numpy; launches {nonzero(ll)}; wall {wall:.3f}s")

    # the CLI default device_batch: one group a dispatch
    clear()
    p_ga = cache_params("group_avg")
    kernels.reset_launches()
    qr = run_query(ctab, p_ga, dataclasses.replace(cflags, device_batch=16))
    ll = kernels.snapshot()
    if cache_snapshot(qr) != uncached["group_avg"]:
        fail("cache group_avg at device_batch 16 differs from uncached")
    if ll["dense_scan"] != ng or ll["dense_pack"] != ng:
        fail(f"cache group_avg at device_batch 16: launches {nonzero(ll)}, "
             f"expected one K2 and one K3 a group")
    tally(launches, ll)
    say(f"cache group_avg at device_batch 16 (one group a dispatch) == "
        f"uncached; launches {nonzero(ll)}")

    # kernels at the captured vgroup shapes and on synthetic batches
    t0 = time.perf_counter()
    checked = cache_check_captured(captured, errs)
    edges = cache_edge_checks(device, errs)
    say(f"cache-group key: K2/K4/K5/K3/K13 and K7/sort_permute/K8/K9/K5/K10 "
        f"== plain (tolerance 0) at the sweep's vgroup shapes ("
        + "; ".join(checked) + ") and on synthetic batches ("
        + "; ".join(edges) + f") in {time.perf_counter() - t0:.1f}s")

    # walls: the median of 5 warm runs of each mode
    def wall(fn, before=None):
        ws = []
        for _ in range(5):
            if before:
                before()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            ws.append((time.perf_counter() - t) * 1e3)
        return median(ws), ws

    sweep_ms = {}
    for kind in CACHE_SWEEP + CACHE_EXTRA:
        params = cache_params(kind)
        mu, wu = wall(lambda: run_query(ctab, params, flags))
        mw, ww = wall(lambda: run_query(ctab, params, cflags), clear)
        mh, wh = wall(lambda: run_query(ctab, params, cflags))
        sweep_ms[kind] = (mu, mw, mh)
        say(f"[{card}] cache {kind}: warm wall median of 5, uncached "
            f"{mu:.3f} ms, write {mw:.3f} ms, hit {mh:.3f} ms (walls "
            f"{[round(x, 3) for x in wu]}, {[round(x, 3) for x in ww]}, "
            f"{[round(x, 3) for x in wh]})")
    say(json.dumps({"cache_sweep_ms": {
        k: {"uncached": u, "write": w, "hit": h}
        for k, (u, w, h) in sweep_ms.items()}, "card": card}))

    # the engine's phases of a write and of a hit
    for kind in ("group_avg", "time_avg"):
        params = cache_params(kind)
        for run in ("write", "hit"):
            if run == "write":
                clear()
            err = io.StringIO()
            dbg.DEBUG_FLAG = True
            with contextlib.redirect_stderr(err):
                run_query(ctab, params, cflags)
            dbg.DEBUG_FLAG = False
            line = [x for x in err.getvalue().splitlines()
                    if "QUERY TIMING" in x][-1]
            say(f"[{card}] cache {kind} {run} query phases: "
                + line.split("QUERY TIMING ", 1)[1])

    # 16 more full blocks: the old groups hit, the new one misses
    clear()
    run_query(ctab, p_ga, cflags)          # the cache of the old groups
    rows_per = max(b.num_records for b in infos.values())
    n_new = CACHE_SPAN * rows_per
    rng = np.random.default_rng(BENCH_SEED + len(up["host"]))
    h_new = rng.integers(0, 5, n_new)
    s_new = rng.integers(0, 5, n_new)
    p_new = np.abs(rng.normal(60, 20, n_new)).astype(np.int64)
    t0 = time.perf_counter()
    ctab.ingest_columns(
        ints={"ping": p_new,
              "weight": rng.choice([1, 10, 100], n_new).astype(np.int64),
              "time": BENCH_NOW + rng.integers(-2419200, 2419200, n_new),
              "index_int": np.arange(n_new, dtype=np.int64)
              + len(up["host"])},
        strs={"host": [HOSTS[i] for i in h_new],
              "status": [STATII[i] for i in s_new]})
    infos2 = ctab.block_infos()
    groups2, rest2 = qcache.stable_groups(list(infos2), infos2)
    say(f"cache phase: appended {n_new} rows ({len(infos2) - len(infos)} "
        f"blocks, {len(groups2)} cache groups now) in "
        f"{time.perf_counter() - t0:.1f}s")
    if len(groups2) != ng + 1 or len(rest2) != len(rest):
        fail(f"cache phase: {len(groups2)} groups and {len(rest2)} other "
             f"blocks after the append")
    h0, m0 = qcache.HITS, qcache.MISSES
    kernels.reset_launches()
    qr = run_query(Table("uptime", flags), p_ga, cflags)
    ll = kernels.snapshot()
    hits, misses = qcache.HITS - h0, qcache.MISSES - m0
    want2 = numpy_groupby(np.concatenate([up["host"], h_new]),
                          np.concatenate([up["ping"], p_new]))
    for h, (cnt, s) in want2.items():
        r = qr.results[h + "\t"]
        if r.count != cnt or r.hists["ping"].avg != s / cnt:
            fail(f"cache group_avg after the append: group {h} differs "
                 f"from numpy")
    if (hits, misses) != (ng, 1):
        fail(f"cache group_avg after the append: {hits} hits and {misses} "
             f"misses, not {ng} and 1")
    tally(launches, ll)
    say(f"cache group_avg after the append: {hits} hits, {misses} miss(es) "
        f"== numpy over {len(up['host']) + n_new} rows; launches "
        f"{nonzero(ll)}")
    rows = cache_kernel_rows(card, captured, device)
    del captured
    shutil.rmtree(croot, ignore_errors=True)
    return rows


def queued_ms(fn, iters: int = 20) -> float:
    """cuda_ms behind a sleep kernel long enough that the host has queued
    every launch before the first starts: the kernels' own time, without
    the wrappers' host time (as sybil_tpu_torch/k2_ab.py times them)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_launches(fn, tries: int = 8):
    """The device work of one call of fn as torch.profiler's CUDA
    activity records it: (kernels and copies a call, {name: (count, self
    device us)}), the most over `tries` profiled calls (a profile
    sometimes misses a short call's events, it never adds any), or (None,
    the reason) when it records none.  When the first `tries` profiles
    record no device event, up to 2 * `tries` more are taken, each with
    its window padded by PROFILE_PAD_S of host time either side of the
    call; PROFILE_MISSES counts those calls and how many the padded
    profiles recovered."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = (None, "the profiler recorded no device event")
    missed = False
    for i in range(3 * tries):
        if i == tries:
            if best[0] is not None:
                break
            missed = True
            PROFILE_MISSES["calls"] += 1
        pad = PROFILE_PAD_S if missed else 0.0
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                fn()
                torch.cuda.synchronize()
                time.sleep(pad)
            dev = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        except Exception as exc:   # the profiler is optional here
            return None, f"{type(exc).__name__}: {exc}"
        n = sum(e.count for e in dev)
        if dev and (best[0] is None or n > best[0]):
            best = (n, {e.key[:48]: (e.count, getattr(
                e, "self_device_time_total",
                getattr(e, "self_cuda_time_total", 0.0))) for e in dev})
    if missed and best[0] is not None:
        PROFILE_MISSES["recovered"] += 1
    return best


# device_launches' calls whose first profiles recorded no device event,
# and those of them that a padded profile recovered
PROFILE_MISSES = {"calls": 0, "recovered": 0}
PROFILE_PAD_S = 0.05


def recorded_launches(fn):
    """device_launches(fn) for a check that needs the count: a call the
    profiler recorded nothing of is profiled again, up to LATE_ROUNDS
    times in all, LATE_ROUND_GAP_S apart."""
    for rnd in range(LATE_ROUNDS):
        got = device_launches(fn)
        if got[0] is not None:
            return got
        if rnd + 1 < LATE_ROUNDS:
            time.sleep(LATE_ROUND_GAP_S)
    return got

# (label, call) pairs whose device work the kernel-times phase profiles:
# calls made in earlier phases, so that no profiler session runs before
# the mesh phase's launch-count checks (device_launches)
LATE_PROFILES = []


def profiled_kernels(fn) -> str:
    """device_launches(fn) as text: each kernel's (or copy's) name with
    its count and self device time, and their total; "not measured" with
    the reason when the profiler records none."""
    n, per = device_launches(fn)
    if n is None:
        return f"not measured ({per})"
    return (f"{n} device ops, {sum(us for _, us in per.values()):.1f} us: "
            + "; ".join(f"{k} x{c} {us:.1f} us"
                        for k, (c, us) in per.items()))


def cache_kernel_rows(card, captured, device) -> list:
    """Each kernel with the cache-group key at the sweep's vgroup shapes:
    K2 at group_avg's (beside the same launch without the key, back to
    back and queued), K7 and K8 at group_tdigest's, K5 at group_loghist's
    -> the kernel table's rows (name, shape, replaces, ms, plain ms,
    bytes, operations, library ms)."""
    import torch

    from sybil_tpu_torch.ops import scan
    rows = []

    def referenced(cfg):
        return {*scan.key_columns(cfg), *(a.col for a in cfg.aggs),
                *(f.col for f in cfg.filters),
                *([cfg.time_col] if cfg.time_col else []),
                *([cfg.weight_col] if cfg.weight_col else [])}

    cfg, cols, nrec, fv, bits, tb, _ = captured["group_avg"]
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    ngp = cfg.key_bounds[0][1]
    ms = cuda_ms(lambda: scan.dense_scan(cfg, cols, nrec, fv, bits, tb))
    pms = cuda_ms(lambda: scan.dense_scan_plain(cfg, cols, nrec, fv, bits,
                                                tb), iters=5)
    Sc = scan.reduce_space(cfg)[1]
    L = 2 + 3 * len(cfg.aggs)
    # each referenced column read once (9 B a row; the cache-group key
    # reads none), nrec, the tables written.  Per row: the range test,
    # the cache group (a shift and a 32-bit division, about 20), each
    # key's digit, each aggregation's lanes
    nbytes = len(referenced(cfg)) * R * 9 + B * 4 + Sc * L * 8 + 8
    ops = R * (6 + 20 + 8 * len(scan.key_columns(cfg))
               + 12 * len(cfg.aggs) + 2)
    # one torch call (row 5's yardstick): index_add_ of prebuilt lanes
    # into the same reduce rows by each row's gid, the cg digit first
    krows = scan.key_rows(cfg, cols, torch.arange(R, device=device), tb)
    gid = torch.zeros(R, dtype=torch.int64, device=device)
    for i, (mn, card_) in enumerate(cfg.key_bounds):
        k = krows[:, i]
        gid = gid * (card_ + 1) + torch.where(k == -1, 0, k - mn + 1).clamp(
            0, card_)
    inrange = (torch.arange(C, device=device)[None, :]
               < nrec.to(torch.int64)[:, None]).reshape(-1)
    gid = torch.where(inrange, gid, Sc - 1).clamp(max=Sc - 1)
    lanes = torch.ones((R, L), dtype=torch.int64, device=device)
    lib = cuda_ms(lambda: torch.zeros((Sc, L), dtype=torch.int64,
                                      device=device).index_add_(0, gid,
                                                                lanes),
                  iters=5)
    del krows, gid, lanes
    rows.append(("dense_scan", f"cache group_avg: the cg digit, ngp {ngp}, "
                 f"{B} blocks", "sybil_tpu/ops/scan.py:405", ms, pms, nbytes,
                 ops, lib))
    # the A/B: the same launch without the cache-group key (config 1's
    # shape over the same batch)
    base = dataclasses.replace(cfg, group_cols=cfg.group_cols[1:],
                               key_bounds=cfg.key_bounds[1:], vg_span=0)
    ab = []
    for label, c in (("with the cg key", cfg), ("without it", base),
                     ("with the cg key", cfg), ("without it", base)):
        ab.append(f"{label} {cuda_ms(lambda: scan.dense_scan(c, cols, nrec, fv, bits, tb)):.4f}"
                  f" ms wall, {queued_ms(lambda: scan.dense_scan(c, cols, nrec, fv, bits, tb)):.4f}"
                  f" ms device")
    say(f"[{card}] K2 A/B at group_avg's batch ({R} rows, ngp {ngp}): "
        + "; ".join(ab))

    cfg, cols, nrec, fv, bits, tb, _ = captured["group_tdigest"]
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    K = cfg.n_key_cols
    F = len(cfg.filters)
    front = scan.sorted_front(cfg, cols, nrec, fv, bits, tb)
    ms = cuda_ms(lambda: scan.sorted_front(cfg, cols, nrec, fv, bits, tb))
    pms = cuda_ms(lambda: scan.sorted_front_plain(cfg, cols, nrec, fv, bits,
                                                  tb), iters=5)
    k7_cols = {*scan.key_columns(cfg), *(f.col for f in cfg.filters),
               *([cfg.time_col] if cfg.time_col else [])}
    # the key columns read once (9 B a row), nrec; idxm and the K key
    # lanes written (the cg lane among them).  Per row: the range test,
    # each filter, each lane, the cg division
    rows.append(("sorted_front", f"cache group_tdigest: the cg lane, K {K}",
                 "sybil_tpu/ops/scan.py:405", ms, pms,
                 len(k7_cols) * R * 9 + B * 4 + F * 8 + R * (4 + 8 * K) + 8,
                 R * (6 + 3 * F + 6 * K + 20), None))
    for k in range(K - 1, -1, -1):
        lane = front["keys"][k]
        say(f"[{card}] sorts, cache group_tdigest: lane {k} stable "
            f"torch.sort of int64 [{R}] "
            f"{cuda_ms(lambda: torch.sort(lane, stable=True)):.4f} ms (bound "
            f"{sort_bound_ms(R, 8):.4f} ms)")
    order = scan.sort_rows(cfg, front)
    ms = cuda_ms(lambda: scan.segment_reduce(cfg, cols, front, order, tb))
    pms = cuda_ms(lambda: scan.segment_reduce_plain(cfg, cols, front, order,
                                                    tb), iters=5)
    S = cfg.max_groups
    L = 2 + 3 * len(cfg.aggs)
    # one torch call (row 14d's yardstick): index_add_ of prebuilt lanes
    # into [S+1, L] by each sorted row's slot
    k8 = scan.segment_reduce(cfg, cols, front, order, tb)
    cg = torch.where((k8["sidxm"] < 0) & (k8["gid"] < S), k8["gid"],
                     S).to(torch.int64)
    lanes = torch.ones((R, L), dtype=torch.int64, device=device)
    lib = cuda_ms(lambda: torch.zeros((S + 1, L), dtype=torch.int64,
                                      device=device).index_add_(0, cg,
                                                                lanes),
                  iters=5)
    del k8, cg, lanes
    ncol = len(cfg.aggs) + (1 if cfg.weight_col else 0)
    # p and base read, idxm and the K lanes gathered, the aggregation
    # columns read once; kmat, sidxm, gid and the tables written.  Per
    # row: the boundary test over K lanes, a block scan, the warp-run
    # sums of each lane
    nbytes = (R * 16 + R * 4 + R * 8 * K + ncol * R * 9 + R * (8 * K + 8)
              + (S + 1) * L * 8 + S * K * 8)
    rows.append(("segment_reduce", f"cache group_tdigest: the cg lane in "
                 f"kmat and the key table, K {K}",
                 "sybil_tpu/ops/scan.py:405", ms, pms, nbytes,
                 R * (12 + 4 * K + 12 * L), lib))
    def k8_call():
        scan.segment_reduce(cfg, cols, front, order, tb)
    say(f"[{card}] segment_reduce cache group_tdigest: device "
        f"{queued_ms(k8_call):.4f} ms, events {ms:.4f} ms, index_add_ "
        f"{lib:.4f} ms")
    # the call's own arguments: the names are rebound or deleted below
    LATE_PROFILES.append(("segment_reduce cache group_tdigest",
                          functools.partial(scan.segment_reduce, cfg, cols,
                                            front, order, tb)))
    del front, order

    cfg, cols, nrec, fv, bits, tb, _ = captured["group_loghist"]
    B, C = next(iter(cols.values()))[0].shape
    R = B * C
    k2 = scan.dense_scan(cfg, cols, nrec, fv, bits, tb)
    h = scan.dense_hist(cfg, 0, cols, k2["gid"])
    lay = scan.packed_layout(cfg, R)
    main = torch.zeros((lay["rows"], lay["W"]), dtype=torch.int64,
                       device=device)
    off, kmax = lay["out0"]
    mk, vk = h["out_mask"], h["out_val"]
    ms = cuda_ms(lambda: scan.outlier_compact(cfg, cols, mk, vk, main, off,
                                              tb), iters=50)
    pms = cuda_ms(lambda: scan.outlier_compact_plain(cfg, cols, mk, vk, main,
                                                     off, tb), iters=5)
    n5 = int(h["nout"].item())
    K = cfg.n_key_cols

    def lib5():
        # row 13e's yardstick: nonzero, then the first kmax rows' keys
        # and values gathered
        idx = torch.nonzero(mk).reshape(-1)[:kmax]
        return scan.key_rows(cfg, cols, idx, tb), vk[idx]
    lib = cuda_ms(lib5, iters=20)
    # the mask read, the live rows' key columns and values gathered, the
    # section written
    rows.append(("outlier_compact", f"cache group_loghist: cg key rows "
                 f"({n5} outliers)", "sybil_tpu/ops/scan.py:424", ms, pms,
                 R + min(n5, kmax) * (9 * K + 8) + kmax * lay["W"] * 8,
                 R * 2 + kmax * lay["W"], lib))
    for name, what, _, ms, pms, *_ in rows:
        say(f"[{card}] {name} ({what}): {ms:.4f} ms (plain {pms:.4f} ms)")
    return rows


# ---------------------------------------------------------------------------
# the mesh scan (-data-shards) and the hash-partitioned shuffle
# ---------------------------------------------------------------------------

MESH_D = 8                      # MULTICHIP_r05.json: n_devices 8
# the wrappers the checked run holds to their plain versions
MESH_CHECKED = ("shuffle_partition", "shuffle_keys", "shuffle_reduce",
                "shuffle_unpack", "topk_rows", "dense_pack", "sorted_pack")


# K16's corner cases, one owner's received rows each (the CPU test
# tests/test_torch_shuffle.py holds the plain versions to the reference
# on the same rows): the payload shapes, as scan config fields, at the
# mesh queries' widths: "wide" config 3 -loghist's (1 key, a 166-bucket
# hist: WP 174, the reduce's warp-a-row walk), "narrow" path 2's (2 keys,
# an avg: WP 9, a row a lane), "three keys" (WP 10)
K16_AVG = dict(hist_min=0, bucket_size=1, num_values=0, discard_min=-10 ** 9,
               discard_max=10 ** 9)
K16_SHAPES = {
    "wide": dict(group_cols=("host",), aggs=(("ping", dict(
        hist_min=0, bucket_size=1, num_values=166, discard_min=0,
        discard_max=165)),), filters=(), key_bounds=((0, 5),)),
    "narrow": dict(group_cols=("action", "page"),
                   aggs=(("weight", K16_AVG),), filters=(),
                   force_sorted=True),
    "three keys": dict(group_cols=("host", "status", "page"),
                       aggs=(("weight", K16_AVG),), filters=(),
                       force_sorted=True),
}
# case -> (shapes, rows N, merge cap)
K16_CASES = {
    "no live row": (("wide", "narrow"), 1024, 128),
    "every row live, one key": (("wide", "narrow"), 2048, 256),
    "INT64_MAX keys tied with dead rows": (("wide", "narrow"), 2048, 256),
    "segments past cap": (("wide", "narrow"), 2048, 64),
    "MISSING keys": (("three keys",), 2048, 256),
    "a 5,000-row segment": (("wide", "narrow"), 8192, 1024),
}
# on the card also path 2's owner (201,024 rows, 95% dead, a 1,500-row
# segment across the merge's tiles), without and with one tied row
K16_CARD_CASES = dict(K16_CASES, **{
    "path 2's owner": (("narrow",), 201_024, 25_128),
    "path 2's owner, one tied row": (("narrow",), 201_024, 25_128),
})
I64_MAX = 2 ** 63 - 1


def k16_case_rows(case: str, K: int, WP: int, N: int, seed: int = 0):
    """One owner's received rows [N, WP] int64 (numpy) for K16's corner
    case `case`: random words; live rows with count or samples > 0; dead
    rows with both 0 and their other words random, as the merge must
    ignore them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2 ** 40, 2 ** 40, (N, WP), dtype=np.int64)
    keys = rng.integers(0, max(2, N // 4), (N, K), dtype=np.int64)
    live = rng.random(N) < 0.8
    if case == "no live row":
        live[:] = False
    elif case == "every row live, one key":
        live[:] = True
        keys[:] = 7
    elif case == "INT64_MAX keys tied with dead rows":
        keys[rng.random(N) < 0.15] = I64_MAX           # all K keys
        keys[rng.random(N) < 0.05, 0] = I64_MAX        # the first only
    elif case == "segments past cap":
        keys = rng.integers(0, 8 * N, (N, K), dtype=np.int64)
    elif case == "MISSING keys":
        keys = rng.integers(-1, 3, (N, K), dtype=np.int64)   # -1: MISSING
    elif case == "a 5,000-row segment":
        seg = rng.choice(N, 5000, replace=False)
        keys[seg] = -3
        live[seg] = True
    elif case.startswith("path 2's owner"):
        live = rng.random(N) < 0.05
        keys = rng.integers(0, N, (N, K), dtype=np.int64)
        seg = rng.choice(np.flatnonzero(live), 1500, replace=False)
        keys[seg] = N // 2
        if case.endswith("one tied row"):
            keys[seg[0]] = I64_MAX
    else:
        raise ValueError(f"unknown K16 case {case!r}")
    rows[:, :K] = keys
    count = rng.integers(1, 100, N)
    count[rng.random(N) < 0.1] = 0                     # samples only
    rows[:, K] = np.where(live, count, 0)
    rows[:, K + 1] = np.where(live, rng.integers(1, 100, N), 0)
    return rows


def mesh_snapshot(qr):
    """snapshot() with each group's distinct registers and the samples."""
    rows, cum, matched = snapshot(qr)
    regs = {k: bytes(r.distinct.registers) for k, r in qr.results.items()
            if getattr(r, "distinct", None) is not None}
    tres = {tb: {k: (r.count, r.samples) for k, r in rs.items()}
            for tb, rs in qr.time_results.items()}
    return rows, cum, matched, regs, tres, qr.samples


def k16_keys_check(what, config, recv, got, errs) -> None:
    """shuffle_keys' outputs `got` (front, src, off) against its plain
    version's, word for word, the packed key or the lanes alike."""
    from sybil_tpu_torch.parallel import mesh
    (front, src, off), (wfront, wsrc, woff) = got, \
        mesh.shuffle_keys_plain(config, recv)
    for part in ("key", "keys"):
        if (front[part] is None) != (wfront[part] is None):
            fail(f"{what}: the kernel's sort operands take the form of "
                 f"{[k for k in front if front[k] is not None]}, the plain "
                 f"version's {[k for k in wfront if wfront[k] is not None]}")
        if front[part] is not None:
            check_equal(f"{what} {part}", front[part], wfront[part],
                        errs["shuffle_keys"])
    check_equal(f"{what} src", src, wsrc, errs["shuffle_keys"])
    check_equal(f"{what} off", off, woff, errs["shuffle_keys"])


def k16_reduce_check(what, config, recv, src, order, off, merged, flive,
                     stats, errs) -> None:
    """shuffle_reduce's outputs (merged, flive, stats' word 0, filled)
    against its plain version's on the same inputs, word for word."""
    import torch

    from sybil_tpu_torch.parallel import mesh
    m2, f2 = torch.empty_like(merged), torch.empty_like(flive)
    s2 = stats.clone()
    mesh.shuffle_reduce_plain(config, recv, src, order, off, m2, f2, s2)
    what += f" (Dl {recv.shape[0]}, N {recv.shape[1]}, cap {merged.shape[1]})"
    for part, a, b in (("merged", merged, m2), ("flive", flive, f2),
                       ("stats", stats, s2)):
        check_equal(f"{what} {part}", a, b, errs["shuffle_reduce"])


def k16_unpack_check(what, config, flat, flive, top, stats, S, got,
                     errs) -> None:
    """shuffle_unpack's outputs `got` against its plain version's."""
    from sybil_tpu_torch.parallel import mesh
    want = mesh.shuffle_unpack_plain(config, flat, flive, top, stats, S)
    for key in ("keys", "sums", "mins", "maxs", "meta"):
        check_equal(f"{what} {key}", got[key], want[key],
                    errs["shuffle_unpack"])
    for i, (a, b) in enumerate(zip(got["hists"], want["hists"])):
        check_equal(f"{what} hist {i}", a, b, errs["shuffle_unpack"])


def k16_stacked_rows(K: int, WP: int, N: int = 2048, Dl: int = 8):
    """A mesh batch's received rows [Dl, N, WP] (numpy) for the stacked
    check: owner d the rows of the N-row K16 cases in turn (seed 20 + d),
    owner 1 all dead (random words, count and samples 0), the last owner
    empty (all zero: no shard sent it a row)."""
    import numpy as np
    cases = [c for c, (_, n, _) in K16_CASES.items() if n == N]
    out = np.stack([k16_case_rows(cases[d % len(cases)], K, WP, N,
                                  seed=20 + d) for d in range(Dl)])
    out[1, :, K:K + 2] = 0
    out[-1] = 0
    return out


def k16_edge_checks(card, device, errs) -> None:
    """K16's corner cases (K16_CARD_CASES, each at its shapes' full
    widths) through the kernels on the card, each entry held to its plain
    version word for word: shuffle_keys, the owners' sorts,
    shuffle_reduce (rows that tie the dead rows' keys and rows that do
    not; both reduce forms: a row a lane at WP 9 and 10, a warp a row at
    WP 174), then two owners' merged tables compacted by K12 and unpacked
    into a table past the live rows; and at each shape one stacked call
    over 8 owners (k16_stacked_rows) against the plain version run owner
    by owner."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.parallel import mesh
    seen, forms = set(), set()
    n = 0
    for case, (shapes, N, cap) in K16_CARD_CASES.items():
        for shape in shapes:
            o = dict(K16_SHAPES[shape])
            o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o["aggs"])
            config = scan.ScanConfig(no_compact_table=True, **o)
            K, A, hist_ais, nv_total, n_sum, WP = mesh.payload_spec(config)
            rows_np = k16_case_rows(case, K, WP, N, seed=11)
            recv = torch.from_numpy(rows_np).to(device)[None]
            what = f"K16 case {case!r} at {shape} (WP {WP}, N {N}, cap {cap})"
            got = mesh.shuffle_keys(config, recv)
            k16_keys_check(f"shuffle_keys {what}", config, recv, got, errs)
            front, src, off = got
            forms.add("packed " + str(front["key"].dtype) if front["key"]
                      is not None else "lanes")
            order = scan.sort_rows(config, front)
            merged = torch.full((1, cap, WP), FILL, dtype=torch.int64,
                                device=device)
            flive = torch.full((1, cap), -7, dtype=torch.int32,
                               device=device)
            stats = torch.full((1, mesh.n_stats(config)), -7,
                               dtype=torch.int64, device=device)
            mesh.shuffle_reduce(config, recv, src, order, off, merged,
                                flive, stats)
            k16_reduce_check(f"shuffle_reduce {what}", config, recv, src,
                             order, off, merged, flive, stats, errs)
            live = (rows_np[:, K] > 0) | (rows_np[:, K + 1] > 0)
            tied = live & (rows_np[:, :K] == I64_MAX).all(axis=1)
            seen.add(("tied" if tied.any() else "untied", "wide" if n_sum
                      + 2 * A > 32 else "narrow"))
            flat = torch.cat([merged[0], torch.roll(merged[0], 5, 0)])
            fl = torch.cat([flive[0], torch.roll(flive[0], 5, 0)])
            S = cap + cap // 2
            top = scan.topk_rows(fl, min(S, flat.shape[0]), two_valued=True)
            g = torch.Generator(device=device).manual_seed(3)
            st2 = torch.randint(0, 50, (2, mesh.n_stats(config)),
                                generator=g, device=device)
            st2[:, 0] = stats[0, 0]
            un = mesh.shuffle_unpack(config, flat, fl, top, st2, S)
            k16_unpack_check(f"shuffle_unpack {what}", config, flat, fl, top,
                             st2, S, un, errs)
            n += 1
    want = {(w, f) for w in ("tied", "untied") for f in ("wide", "narrow")}
    if seen != want:
        fail(f"K16 corner cases ran {sorted(seen)}, not {sorted(want)}")
    want = {"lanes", "packed torch.int32", "packed torch.int64"}
    if forms != want:
        fail(f"K16 corner cases sorted by {sorted(forms)}, not "
             f"{sorted(want)}")
    # one stacked call over 8 owners against the plain version owner by
    # owner
    for shape in ("wide", "narrow", "three keys"):
        o = dict(K16_SHAPES[shape])
        o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o["aggs"])
        config = scan.ScanConfig(no_compact_table=True, **o)
        K, *_, WP = mesh.payload_spec(config)
        recv = torch.from_numpy(k16_stacked_rows(K, WP)).to(device)
        Dl, cap = recv.shape[0], 256
        out = [torch.full((Dl, cap, WP), FILL, dtype=torch.int64,
                          device=device),
               torch.full((Dl, cap), -7, dtype=torch.int32, device=device),
               torch.full((Dl, mesh.n_stats(config)), -7, dtype=torch.int64,
                          device=device)]
        mesh.merge_owners(config, recv, *out)
        for d in range(Dl):
            want = [torch.empty_like(out[0][:1]), torch.empty_like(
                out[1][:1]), out[2][d:d + 1].clone()]
            one = recv[d:d + 1]
            front, src, off = mesh.shuffle_keys_plain(config, one)
            mesh.shuffle_reduce_plain(config, one, src, scan.sort_rows(
                config, front), off, *want)
            for part, a, b in zip(("merged", "flive", "stats"), out, want):
                check_equal(f"K16 stacked call over {Dl} owners at {shape}, "
                            f"owner {d}'s {part}", a[d:d + 1], b,
                            errs["shuffle_reduce"])
        n += 1
    say(f"[{card}] K16 corner cases: {n} (case, shape) pairs and stacked "
        f"calls over 8 owners, shuffle_keys (sort keys {sorted(forms)}), "
        f"shuffle_reduce (rows tied with the dead rows and not, both reduce "
        f"forms) and shuffle_unpack == their plain versions word for word")


# K2's shared and global forms, corner cases (tests/test_torch_scan.py
# holds the plain version to the reference's _scan_dense and _dense_gid on
# the same batches, made smaller): name -> options.  keys: the group keys'
# (min, card); layout "random" (MISSING keys among them), "one" (every
# row on one gid) or "lanes" (row r on gid r % 32: a warp's 32 rows on 32
# gids); aggs "avg" or "hist" (a histogram aggregation: min/max, gid_out);
# filters: (column, op, value, kind) on the int column f or the str column
# s; weight: a weight column of +-2^40 and values of +-2^62 (wrapping
# 64-bit lanes); mask: the matched mask; cg: the cache-group key
# (vg_span 2) ahead of the keys; time: a time key's (quotient min, card)
# at tb 1,000, not windowed unless `window`; spill: keys and quotients
# past their bounds; form: the form launched (default dense_scan_path's).
# The last block holds C // 2 + 3 records.  On the card (B 4, C 65,536)
# the cards at the limits put the shared form's tables where the names say
# (scan.dense_scan_route: 32 narrow tables of 204 slots fit the per-warp
# budget, 205 do not; 5,120 wide slots fit SHARED_TABLE_BYTES, 5,121 do
# not; 11,520 windowed slots fit one CTA's shared memory).
K2_CASES = {
    "every row of a warp on one gid": dict(keys=((0, 5),), layout="one"),
    "32 gids a warp": dict(keys=((0, 63),), layout="lanes"),
    "filters and the mask": dict(
        keys=((0, 5), (0, 3)), mask=True,
        filters=(("f", "lt", 60, "int"), ("s", "neq", 2, "str"))),
    "weighted, wrapping 64-bit lanes": dict(keys=((0, 5),), weight=True),
    "hist min/max and gid_out": dict(keys=((0, 5), (0, 4)), aggs="hist"),
    "the cache-group key": dict(keys=((0, 5),), cg=True, aggs="hist"),
    "a time key, not windowed": dict(keys=((0, 5),), time=(50, 20)),
    "spilled keys and quotients": dict(keys=((0, 3),), time=(50, 20),
                                       spill=True),
    "per-warp tables at their limit": dict(keys=((0, 202),)),
    "a table a CTA past the per-warp limit": dict(keys=((0, 203),)),
    "a table a CTA at the shared limit": dict(keys=((0, 5118),)),
    "global tables past the shared limit": dict(keys=((0, 5119),)),
    "the global form forced": dict(keys=((0, 5), (0, 4)), aggs="hist",
                                   form="global"),
    "a windowed table at the resident limit": dict(
        keys=((0, 9),), time=(50, 1150), window=128),
}
K2_TB = 1000


def k2_case(name: str, B: int, C: int, seed: int = 0):
    """K2's corner case `name` as numpy arrays and scan config fields ->
    (fields (aggs as (col, AggSpec fields) pairs, filters as (col, op,
    kind) triples), {col: (values int64 [B, C], valid bool [B, C])}, nrec
    int32 [B], filter values int64 [F], time bucket, form or None)."""
    import numpy as np
    o = K2_CASES[name]
    rng = np.random.default_rng(seed + sorted(K2_CASES).index(name))
    R = B * C
    cols = {}

    def put(col, v, m):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     np.asarray(m, bool).reshape(B, C))

    spill = o.get("spill", False)
    layout = o.get("layout", "random")
    groups, bounds = [], []
    if o.get("cg"):
        groups.append("__cg__")
        bounds.append((0, B // 2))
    if o.get("time"):
        q0, tcard = o["time"]
        q = rng.integers(q0 - 20 if spill else q0,
                         q0 + tcard + (20 if spill else 0), R)
        put("t", q * K2_TB + rng.integers(0, K2_TB, R), rng.random(R) < 0.95)
        bounds.append((q0, tcard))
    for i, (mn, card) in enumerate(o["keys"]):
        if layout == "one":
            k, m = np.full(R, mn + 2), np.ones(R, bool)
        elif layout == "lanes":
            k, m = mn + np.arange(R) % 32, np.ones(R, bool)
        else:
            k = rng.integers(mn, mn + card + (1 if spill else 0), R)
            m = rng.random(R) < 0.9
        put(f"k{i}", k, m)
        groups.append(f"k{i}")
        bounds.append((mn, card))
    big = 2 ** 62 if o.get("weight") else 0
    put("v", rng.integers(-big, big, R) if big else
        rng.integers(-200, 700, R), rng.random(R) < 0.85)
    put("f", rng.integers(0, 80, R), rng.random(R) < 0.95)
    put("s", rng.integers(0, 4, R), rng.random(R) < 0.9)
    if o.get("weight"):
        put("w", rng.integers(-2 ** 40, 2 ** 40, R), rng.random(R) < 0.9)
    if o.get("aggs") == "hist":
        aggs = (("v", dict(hist_min=0, bucket_size=10, num_values=20,
                           discard_min=-100, discard_max=650)),)
    else:
        aggs = (("v", dict(hist_min=0, bucket_size=0, num_values=0,
                           discard_min=-big or -100,
                           discard_max=big or 600)),)
    window = o.get("window", 0)
    fields = dict(
        group_cols=tuple(groups), aggs=aggs,
        filters=tuple((c, op, kind) for c, op, _, kind in
                      o.get("filters", ())),
        time_col="t" if o.get("time") else "",
        weight_col="w" if o.get("weight") else "", key_bounds=tuple(bounds),
        window=window, window_chunk=min(C, 8192) if window else 0,
        time_i32=bool(o.get("time")), want_matched_mask=bool(o.get("mask")),
        vg_span=2 if o.get("cg") else 0)
    nrec = np.full(B, C, np.int32)
    nrec[-1] = C // 2 + 3
    fvals = np.asarray([v for _, _, v, _ in o.get("filters", ())], np.int64)
    return fields, cols, nrec, fvals, K2_TB, o.get("form")


def k2_edge_checks(card, device, errs) -> None:
    """K2's shared and global forms on the card over K2_CASES (B 4, C
    65,536), each launch held to its plain version word for word: every
    form that applies (shared and global; windowed and global for a
    windowed rollup) or the case's own.  Fails unless every route of the
    tiled kernel (scan.K2_PATHS: a table a warp, a table a CTA, the global
    tables) and the windowed form's resident mode ran."""
    import torch

    from sybil_tpu_torch.ops import scan
    total = dict.fromkeys(scan.K2_PATHS, 0)
    resident = 0
    lines = []
    for name in K2_CASES:
        fields, ncols, nrec, fv, tb, form = k2_case(name, 4, 65536)
        cfg = k2w_config(scan, fields)
        cols = {k: (torch.from_numpy(v).to(device),
                    torch.from_numpy(m).to(device))
                for k, (v, m) in ncols.items()}
        nrec_t = torch.from_numpy(nrec).to(device)
        fv_t = torch.from_numpy(fv).to(device)
        forms = ([form] if form else ["windowed", "global"]
                 if scan.windowed(cfg) else
                 ["shared", "global"] if scan.dense_scan_path(cfg) == "shared"
                 else ["global"])
        want = scan.dense_scan_plain(cfg, cols, nrec_t, fv_t, (), tb)
        took = []
        for f in forms:
            names = scan.WINDOW_PATHS if f == "windowed" else scan.K2_PATHS
            paths = torch.zeros(len(names), dtype=torch.int64, device=device)
            got = scan.dense_scan(cfg, cols, nrec_t, fv_t, (), tb, form=f,
                                  paths=paths)
            check_outs("dense_scan", f"case {name!r} ({f})", got, want,
                       ("sums", "spill", "mins", "maxs", "gid", "mask"), errs)
            for k, n in zip(names, paths.tolist()):
                if n and f != "windowed":
                    total[k] += n
                if n:
                    took.append(k)
            if f == "windowed":
                resident += paths[0].item()
        lines.append(f"{name}: {', '.join(took)}")
    if not all(total.values()) or not resident:
        fail(f"K2's routes {total}, resident CTAs {resident}: each must run")
    say(f"[{card}] K2 shared and global forms == plain word for word on "
        f"{len(K2_CASES)} corner cases; routes (CTAs) {total}, windowed "
        f"resident {resident}: " + "; ".join(lines))


# K4's corner cases (tests/test_torch_hist_hll_cases.py holds the plain
# version to the reference's _hist_bucket, _hist_scatter and
# _outlier_outputs on the same batches, made smaller): name -> options.
# keys: key bounds (Sc = the product of card + 1, plus the dead slot);
# hist: (hist_min, bucket_size, nv, discard_min, discard_max), or "multi"
# (K4_MULTI: sub 0's 5 buckets of 10 end at 150, so 150-199 overflow it);
# vals: the values' range (default -50 to 450: below the first bucket,
# past the last and past the discard bound); gids: "random" (a tenth of
# the rows dead), "one" (every row on gid 0), "few" (gids 0-3), "dead"
# (nine rows in ten dead); weight: a weight column of +-2^62 (the counts
# wrap mod 2^64), valid at 90%; outliers: outlier tracking.  The tables
# land where the names say (scan.dense_hist_path: 51,200 words fit
# SHARED_TABLE_BYTES, 51,201, one word past it, do not).
K4_MULTI = ((100, 199, 10, 5, 0), (0, 99, 10, 10, 5))
K4_CASES = {
    "every row in one bucket of one gid": dict(
        keys=((0, 5),), hist=(0, 10, 20, 0, 400), vals=(55, 56), gids="one"),
    "weights that wrap mod 2^64": dict(
        keys=((0, 5),), hist=(0, 10, 20, -200, 700), gids="few",
        weight=True),
    "a multihist value past its sub's array": dict(
        keys=((0, 5),), hist="multi", vals=(-20, 230), outliers=True),
    "discard bounds": dict(keys=((0, 5),), hist=(0, 7, 30, -150, 400),
                           vals=(-300, 500), outliers=True),
    "a bucket size past 32 bits": dict(
        keys=((0, 5),), hist=(-2 ** 40, 2 ** 33, 300, -2 ** 41, 2 ** 41),
        vals=(-2 ** 41, 2 ** 41), outliers=True),
    "the dead gid": dict(keys=((0, 5),), hist=(0, 10, 20, 0, 400),
                         gids="dead", outliers=True),
    "a table at SHARED_TABLE_BYTES": dict(
        keys=((0, 7),), hist=(0, 1, 6400, 0, 7000), vals=(-10, 6500),
        outliers=True),
    "a table one word past SHARED_TABLE_BYTES": dict(
        keys=((0, 8),), hist=(0, 1, 5689, 0, 7000), vals=(-10, 6000),
        outliers=True),
    "global counts, every row on one entry": dict(
        keys=((0, 8),), hist=(0, 1, 5689, 0, 7000), vals=(55, 56),
        gids="one"),
    "global counts, weighted, rows on few entries": dict(
        keys=((0, 90), (0, 89)), hist=(0, 40, 12, 0, 400), vals=(0, 80),
        gids="few", weight=True, outliers=True),
}
# the table each case's K4 takes (scan.dense_hist_path)
K4_ROUTES = {"a table at SHARED_TABLE_BYTES": "shared",
             "a table one word past SHARED_TABLE_BYTES": "global",
             "global counts, every row on one entry": "global",
             "global counts, weighted, rows on few entries": "global"}


def _case_gids(rng, how: str, Sc: int, R: int):
    """int32 [R] reduce-space gids (dead = Sc-1) laid out as `how` says."""
    import numpy as np
    if how == "one":
        return np.zeros(R, np.int32)
    if how == "few":
        return rng.integers(0, min(4, Sc - 1), R).astype(np.int32)
    g = rng.integers(0, Sc - 1, R)
    dead = rng.random(R) < (0.9 if how == "dead" else 0.1)
    return np.where(dead, Sc - 1, g).astype(np.int32)


def k4_case(name: str, B: int, C: int, seed: int = 0):
    """K4's corner case `name` as numpy arrays -> (scan config fields, as
    k2w_config takes them; K2's gid int32 [R]; {col: (values int64 [B,
    C], valid bool [B, C])}; Sc)."""
    import numpy as np

    from sybil_tpu_torch.ops import scan
    o = K4_CASES[name]
    rng = np.random.default_rng(seed + sorted(K4_CASES).index(name))
    R = B * C
    lo, hi = o.get("vals", (-50, 450))
    cols = {"v": (rng.integers(lo, hi, R).reshape(B, C),
                  (rng.random(R) < 0.9).reshape(B, C))}
    if o.get("weight"):
        cols["w"] = (rng.integers(-2 ** 62, 2 ** 62, R).reshape(B, C),
                     (rng.random(R) < 0.9).reshape(B, C))
    if o["hist"] == "multi":
        agg = dict(hist_min=0, bucket_size=0, num_values=15,
                   discard_min=-1000, discard_max=1000, sub_edges=K4_MULTI)
    else:
        hmin, bs, nv, dmin, dmax = o["hist"]
        agg = dict(hist_min=hmin, bucket_size=bs, num_values=nv,
                   discard_min=dmin, discard_max=dmax)
    fields = dict(group_cols=tuple(f"k{i}" for i in range(len(o["keys"]))),
                  aggs=(("v", agg),), filters=(),
                  weight_col="w" if o.get("weight") else "",
                  key_bounds=tuple(o["keys"]),
                  track_outliers=bool(o.get("outliers")))
    Sc = scan.reduce_space(k2w_config(scan, fields))[1]
    return fields, _case_gids(rng, o.get("gids", "random"), Sc, R), cols, Sc


def k4_edge_checks(card, device, errs) -> None:
    """K4 on the card over K4_CASES (B 4, C 65,536), each launch held to
    its plain version word for word (the counts, the outlier mask, values
    and count).  Fails unless every table of scan.K4_PATHS ran (by the
    kernel's own CTA counts), each case in its K4_ROUTES route.  A call's
    device operations (at most 2: the memset and the kernel) are checked
    late, one call a route (LATE_OP_CHECKS)."""
    import torch

    from sybil_tpu_torch.ops import scan
    total = dict.fromkeys(scan.K4_PATHS, 0)
    lines, seen = [], set()
    for name in K4_CASES:
        fields, gid, ncols, _ = k4_case(name, 4, 65536)
        cfg = k2w_config(scan, fields)
        cols = {k: (torch.from_numpy(v).to(device),
                    torch.from_numpy(m).to(device))
                for k, (v, m) in ncols.items()}
        gid_t = torch.from_numpy(gid).to(device)
        route = scan.dense_hist_path(cfg, 0)
        if route != K4_ROUTES.get(name, route):
            fail(f"K4 case {name!r} takes the {route} table, not "
                 f"{K4_ROUTES[name]}")
        paths = torch.zeros(len(scan.K4_PATHS), dtype=torch.int64,
                            device=device)
        got = scan.dense_hist(cfg, 0, cols, gid_t, paths=paths)
        want = scan.dense_hist_plain(cfg, 0, cols, gid_t)
        check_outs("dense_hist", f"case {name!r}", got, want,
                   ("hist", "out_mask", "out_val", "nout"), errs)
        took = [k for k, n in zip(scan.K4_PATHS, paths.tolist()) if n]
        if took != [route]:
            fail(f"K4 case {name!r}: CTAs took {took}, not {route}")
        total[route] += int(paths.sum().item())
        lines.append(f"{name}: {route}")
        if route not in seen:
            seen.add(route)
            LATE_OP_CHECKS.append((
                f"dense_hist {route} ({name})", 2,
                lambda a=(cfg, 0, cols, gid_t): scan.dense_hist(*a)))
    if not all(total.values()):
        fail(f"K4's tables (CTAs) {total}: each must run")
    say(f"[{card}] K4 == plain word for word on {len(K4_CASES)} corner "
        f"cases; tables (CTAs) {total}: " + "; ".join(lines))


# K13's corner cases (tests/test_torch_hist_hll_cases.py holds the plain
# version to the reference's _hash_int_col, _hll_idx_rank and
# _hll_registers on the same batches, made smaller): name -> options.
# keys: key bounds (the planes the rows reach: Sc, the live slots and the
# dead one; 128 slots at most); hash: "int" (FNV-1a and splitmix64 in the
# kernel) or "str" (a per-id hash array of `nd` entries, its last the
# missing value's); vals: the values' range (str: ids, clamped to [0,
# nd-1]); crafted: hash entries whose low 50 bits are zero (rank 51);
# gids: as K4's; valid: the share of rows with a value (MISSING
# otherwise).  The forms follow the planes (scan.hll_route: 12 planes of
# 16 KB fit SHARED_TABLE_BYTES, 13 do not).
K13_CASES = {
    "rank 51, a zero remainder": dict(keys=((0, 5),), hash="str", nd=9,
                                      crafted=True),
    "MISSING values, int hash": dict(keys=((0, 5),), hash="int",
                                     valid=0.5),
    "MISSING values, str hash": dict(keys=((0, 5),), hash="str", nd=40,
                                     valid=0.5),
    "str ids below 0 and past nd - 1": dict(keys=((0, 5),), hash="str",
                                            nd=12, vals=(-5, 18)),
    "one register hit by every row": dict(keys=((0, 5),), hash="int",
                                          vals=(7, 8), gids="one",
                                          valid=1.0),
    "one live slot": dict(keys=((0, 1),), hash="int", gids="one"),
    "8 planes": dict(keys=((0, 6),), hash="str", nd=5000),
    "12 planes, at SHARED_TABLE_BYTES": dict(keys=((0, 10),), hash="int"),
    "13 planes, past it": dict(keys=((0, 11),), hash="int"),
    "128 slots, str hash": dict(keys=((0, 126),), hash="str", nd=6),
    "128 slots, int hash": dict(keys=((0, 126),), hash="int"),
    "the dead slot": dict(keys=((0, 5),), hash="int", gids="dead"),
}
# the form each case's K13 takes (scan.hll_route)
K13_ROUTES = {"12 planes, at SHARED_TABLE_BYTES": "shared",
              "13 planes, past it": "global",
              "128 slots, str hash": "global",
              "128 slots, int hash": "global"}


def k13_case(name: str, B: int, C: int, seed: int = 0):
    """K13's corner case `name` as numpy arrays -> (scan config fields, as
    k2w_config takes them; K2's gid int32 [R]; {"d": (values int64 [B,
    C], valid bool [B, C])}; the str hash array as uint64 [nd], or None;
    Sc)."""
    import numpy as np

    from sybil_tpu_torch.ops import scan
    o = K13_CASES[name]
    rng = np.random.default_rng(seed + sorted(K13_CASES).index(name))
    R = B * C
    str_hash = o["hash"] == "str"
    lo, hi = o.get("vals", (0, o["nd"]) if str_hash else (-2 ** 62,
                                                          2 ** 62))
    cols = {"d": (rng.integers(lo, hi, R).reshape(B, C),
                  (rng.random(R) < o.get("valid", 0.9)).reshape(B, C))}
    hashes = None
    if str_hash:
        hashes = rng.integers(0, 2 ** 64, o["nd"], dtype=np.uint64)
        if o.get("crafted"):
            # the top 14 bits only: rest == 0, rank 51
            hashes[::2] = rng.integers(0, 2 ** 14, len(hashes[::2]),
                                       dtype=np.uint64) << np.uint64(50)
    fields = dict(group_cols=tuple(f"k{i}" for i in range(len(o["keys"]))),
                  aggs=(), filters=(), distinct_cols=("d",),
                  key_bounds=tuple(o["keys"]), hll=True,
                  hll_hash_idx=0 if str_hash else -1)
    Sc = scan.reduce_space(k2w_config(scan, fields))[1]
    return (fields, _case_gids(rng, o.get("gids", "random"), Sc, R), cols,
            hashes, Sc)


def k13_edge_checks(card, device, errs) -> None:
    """K13 on the card over K13_CASES (B 4, C 65,536), each launch held to
    its plain version byte for byte.  Fails unless both forms of
    scan.K13_PATHS ran (by the kernel's own CTA counts), each case in its
    K13_ROUTES form.  A call's device operations (exactly 1: the
    cooperative launch, no memset) are checked late, one call a form
    (LATE_OP_CHECKS)."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import scan
    total = dict.fromkeys(scan.K13_PATHS, 0)
    lines, seen = [], set()
    for name in K13_CASES:
        fields, gid, ncols, hashes, _ = k13_case(name, 4, 65536)
        cfg = k2w_config(scan, fields)
        cols = {k: (torch.from_numpy(v).to(device),
                    torch.from_numpy(m).to(device))
                for k, (v, m) in ncols.items()}
        gid_t = torch.from_numpy(gid).to(device)
        bits = (() if hashes is None else
                (torch.from_numpy(hashes.view(np.int64)).to(device),))
        route = scan.hll_route(cfg)
        if route != K13_ROUTES.get(name, "shared"):
            fail(f"K13 case {name!r} takes the {route} form")
        paths = torch.zeros(len(scan.K13_PATHS), dtype=torch.int64,
                            device=device)
        got = scan.hll_registers(cfg, cols, gid_t, bits, paths=paths)
        want = scan.hll_registers_plain(cfg, cols, gid_t, bits)
        check_equal(f"hll_registers case {name!r}", got, want,
                    errs["hll_registers"])
        took = [k for k, n in zip(scan.K13_PATHS, paths.tolist()) if n]
        if took != [route]:
            fail(f"K13 case {name!r}: CTAs took {took}, not {route}")
        total[route] += int(paths.sum().item())
        lines.append(f"{name}: {route}")
        if route not in seen:
            seen.add(route)
            LATE_OP_CHECKS.append((
                f"hll_registers {route} ({name})", 1,
                lambda a=(cfg, cols, gid_t, bits): scan.hll_registers(*a)))
    if not all(total.values()):
        fail(f"K13's forms (CTAs) {total}: each must run")
    say(f"[{card}] K13 == plain byte for byte on {len(K13_CASES)} corner "
        f"cases; forms (CTAs) {total}: " + "; ".join(lines))


# K2's windowed form, corner cases (tests/test_torch_rollup.py holds the
# plain version to the reference's windowed _scan_dense on the same
# batches, made smaller): name -> options.  tcard: the time key's
# quotient cardinality (1 s buckets of tb = 1000 from quotient 50); aggs
# "avg", "hist" (H = 1) or "many" (16 avg aggregations); layout "random",
# "sorted" or "one" (every row on one slot); spill: times past the
# quotient bound on both sides; filter: an int filter's (op, value);
# dead: rows out of their block's record count and without the time
# column (the dead slot); weight: a weight column, with the values, of
# +-2^40 and +-2^62 (wrapping 64-bit lanes); mask: the matched mask; cg:
# the cache-group key (vg_span 2) ahead of the time key.  On the card
# (B 3 or 4, C 65,536: 24 or 32 chunks of 8,192 rows) they take the
# windowed form's paths as the comments say.
K2W_CASES = {
    # per chunk: a 7,040-slot table of 36 B slots, all of it a chunk's
    # span at 1.2 rows a slot: direct
    "span wider than the shared budget, sparse": dict(
        tcard=699, aggs="hist", layout="random"),
    # per chunk: 1,024 slots of 260 B, band 764, 8 rows a slot: banded
    "span wider than the shared budget, dense": dict(
        tcard=99, aggs="many", layout="random"),
    # per chunk: full-span over one slot, every warp one group
    "every row on one slot": dict(tcard=699, aggs="hist", layout="one"),
    # per chunk: every chunk empty
    "no matched row": dict(tcard=699, aggs="hist", layout="random",
                           filter=("gt", 10 ** 9)),
    # resident (5,120 slots of 36 B)
    "rows on the dead slot": dict(tcard=499, aggs="hist", layout="sorted",
                                  dead=True),
    # resident (5,120 slots of 20 B)
    "spilled time quotient": dict(tcard=499, aggs="avg", layout="random",
                                  spill=True, filter=("lt", 75)),
    # resident (4 x 100 x 10 + 1 = 4,096 slots of 36 B)
    "hist with the mask and the cache-group key": dict(
        tcard=99, aggs="hist", layout="sorted", mask=True, cg=True,
        filter=("lt", 60)),
    # resident (5,120 slots of 32 B), few slots a warp: carries
    "weighted, wrapping 64-bit lanes": dict(tcard=499, aggs="avg",
                                            layout="sorted", weight=True),
}
K2W_TB = 1000


def k2w_case(name: str, B: int, C: int, seed: int = 0):
    """K2's windowed corner case `name` as numpy arrays and scan config
    fields -> (fields (aggs as (col, AggSpec fields) pairs, filters as
    (col, op, kind) triples), {col: (values int64 [B, C], valid bool
    [B, C])}, nrec int32 [B], filter values int64 [F], time bucket)."""
    import numpy as np
    o = K2W_CASES[name]
    rng = np.random.default_rng(seed + sorted(K2W_CASES).index(name))
    R = B * C
    q0, tcard = 50, o["tcard"]
    lo, hi = (q0 - 20, q0 + tcard + 20) if o.get("spill") else \
        (q0, q0 + tcard)
    q = rng.integers(lo, hi, R)
    if o["layout"] == "sorted":
        q = np.sort(q)
    elif o["layout"] == "one":
        q[:] = q0 + 3
    cols = {}

    def put(col, v, m):
        cols[col] = (np.asarray(v, np.int64).reshape(B, C),
                     np.asarray(m, bool).reshape(B, C))

    put("t", q * K2W_TB + rng.integers(0, K2W_TB, R),
        rng.random(R) < (0.6 if o.get("dead") else 1.0))
    one = o["layout"] == "one"
    put("k0", np.full(R, 4) if one else rng.integers(0, 9, R),
        np.ones(R, bool) if one else rng.random(R) < 0.9)
    big = 2 ** 62 if o.get("weight") else 0
    put("v", rng.integers(-big, big, R) if big else
        rng.integers(-200, 700, R), rng.random(R) < 0.85)
    put("f", rng.integers(0, 80, R), rng.random(R) < 0.95)
    if o.get("weight"):
        put("w", rng.integers(-2 ** 40, 2 ** 40, R), rng.random(R) < 0.9)
    avg = dict(hist_min=0, bucket_size=0, num_values=0,
               discard_min=-big or -100, discard_max=big or 600)
    if o["aggs"] == "hist":
        aggs = (("v", dict(hist_min=0, bucket_size=10, num_values=20,
                           discard_min=-100, discard_max=650)),)
    elif o["aggs"] == "many":
        aggs = tuple(("v", dict(avg, discard_min=-100 + 7 * i,
                                discard_max=600 - 5 * i)) for i in range(16))
    else:
        aggs = (("v", avg),)
    filters, fvals = (), []
    if o.get("filter"):
        filters = (("f", o["filter"][0], "int"),)
        fvals = [o["filter"][1]]
    groups, bounds = ("k0",), ((q0, tcard), (0, 9))
    if o.get("cg"):
        groups, bounds = ("__cg__", "k0"), ((0, B // 2), (q0, tcard), (0, 9))
    fields = dict(group_cols=groups, aggs=aggs, filters=filters,
                  time_col="t", weight_col="w" if o.get("weight") else "",
                  key_bounds=bounds, window=128, window_chunk=min(C, 8192),
                  time_i32=True, want_matched_mask=bool(o.get("mask")),
                  vg_span=2 if o.get("cg") else 0)
    nrec = np.full(B, C, np.int32)
    if o.get("dead"):
        nrec[1] = C // 2 + 3
    return fields, cols, nrec, np.asarray(fvals, np.int64), K2W_TB


def k2w_config(scan, fields):
    """The port's ScanConfig of k2w_case's fields."""
    o = dict(fields)
    o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o["aggs"])
    o["filters"] = tuple(scan.FilterSpec(*f) for f in o["filters"])
    return scan.ScanConfig(**o)


def k2w_check(what, cfg, cols, nrec, errs, fv=None, bits=(), tb=1,
              set_masks=None):
    """K2's windowed form on the card held to its plain version word for
    word (sums, spill, mins, maxs, gids, mask) -> {path: count} of the
    windowed form's paths (scan.WINDOW_PATHS) this launch took."""
    import torch

    from sybil_tpu_torch.ops import scan
    paths = torch.zeros(len(scan.WINDOW_PATHS), dtype=torch.int64,
                        device=nrec.device)
    got = scan.dense_scan(cfg, cols, nrec, fv, bits, tb, form="windowed",
                          set_masks=set_masks, paths=paths)
    want = scan.dense_scan_plain(cfg, cols, nrec, fv, bits, tb, set_masks)
    check_outs("dense_scan", f"{what} (windowed)", got, want,
               ("sums", "spill", "mins", "maxs", "gid", "mask"), errs)
    return dict(zip(scan.WINDOW_PATHS, paths.tolist()))


def k2w_edge_checks(card, device, errs, shapes, cases=True) -> dict:
    """K2's windowed form on the card, each launch held to its plain
    version word for word: the K2W_CASES batches (B 4, C 65,536) when
    `cases`, then each of `shapes` ((label, config, cols, nrec, filter
    values, bitsets, time bucket, set masks), the main path's captured
    batches).  With the cases, fails unless every path of the design ran
    (scan.WINDOW_PATHS).  -> {path: count} over every launch."""
    import torch

    from sybil_tpu_torch.ops import scan
    total = dict.fromkeys(scan.WINDOW_PATHS, 0)
    lines = []
    runs = []
    if cases:
        for name in K2W_CASES:
            fields, ncols, nrec, fv, tb = k2w_case(name, 4, 65536)
            cfg = k2w_config(scan, fields)
            if not scan.windowed(cfg):
                fail(f"K2W case {name!r} is not windowed")
            cols = {k: (torch.from_numpy(v).to(device),
                        torch.from_numpy(m).to(device))
                    for k, (v, m) in ncols.items()}
            runs.append((f"K2W case {name!r}", cfg, cols,
                         torch.from_numpy(nrec).to(device),
                         torch.from_numpy(fv).to(device), (), tb, None))
    for what, cfg, cols, nrec, fv, bits, tb, sm in list(runs) + list(shapes):
        got = k2w_check(what, cfg, cols, nrec, errs, fv, bits, tb, sm)
        for k, n in got.items():
            total[k] += n
        C = next(iter(cols.values()))[0].shape[1]
        lines.append(f"{what}: band/chunk {scan.window_band(cfg, C)}, "
                     + ", ".join(f"{k} {n}" for k, n in got.items() if n))
    if cases and not all(total.values()):
        fail(f"K2's windowed paths {total}: each must run")
    say(f"[{card}] K2 windowed form == plain word for word on "
        f"{len(lines)} batches; paths {total}: " + "; ".join(lines))
    return total


# K12's two-valued form (the mesh's compaction), corner cases
# (tests/test_torch_shuffle.py holds the plain version to lax.top_k on
# the same flags): name -> (rows R, share of ones, k); k -1 is R, and
# "ones-1" / "ones" / "ones+1" are the count of ones and its neighbours.
# R at the one-CTA limit (scan.TOPK_TV_TILE = 16,384) +-1 and across
# many tiles.
K12_CASES = {
    "all zeros": (5000, 0.0, 700),
    "all ones": (5000, 1.0, 700),
    "k below the ones": (3000, 0.3, "ones-1"),
    "k equal to the ones": (3000, 0.3, "ones"),
    "k above the ones": (3000, 0.3, "ones+1"),
    "k = R": (4099, 0.5, -1),
    "R = 1": (1, 1.0, 1),
    "R at the one-CTA limit - 1": (16383, 0.4, 9000),
    "R at the one-CTA limit": (16384, 0.4, -1),
    "R at the one-CTA limit + 1": (16385, 0.4, "ones+1"),
    "R across many tiles": (200_003, 0.05, 100_000),
}


def k12_case(name: str, seed: int = 0):
    """-> (flags int32 [R] of 0 and 1 (numpy), k) of K12_CASES[name]."""
    import numpy as np
    R, share, k = K12_CASES[name]
    rng = np.random.default_rng(seed + sorted(K12_CASES).index(name))
    flags = (rng.random(R) < share).astype(np.int32)
    ones = int(flags.sum())
    if isinstance(k, str):
        k = ones + {"ones-1": -1, "ones": 0, "ones+1": 1}[k]
    elif k == -1:
        k = R
    return flags, k


def k12_edge_checks(card, device, errs, shapes) -> None:
    """K12's two-valued form on the card, held to its plain version word
    for word on the K12_CASES flags and on `shapes` ((label, flags, k), the
    mesh's captured compactions), with its device launches a call from
    torch.profiler: 1 up to scan.TOPK_TV_TILE rows, 2 above.  Fails unless
    both the one-CTA and the tiled form ran."""
    import torch

    from sybil_tpu_torch.ops import scan
    runs = []
    for name in K12_CASES:
        flags, k = k12_case(name)
        runs.append((f"K12 case {name!r}", torch.from_numpy(flags).to(device),
                     k))
    seen, lines = set(), []
    for what, flags, k in runs + list(shapes):
        R = flags.numel()
        got = scan.topk_rows(flags, k, two_valued=True)
        check_equal(f"topk_rows two-valued {what} ([{R}], k {k})", got,
                    scan.topk_rows_plain(flags, k), errs["topk_rows"])
        n, per = recorded_launches(
            lambda: scan.topk_rows(flags, k, two_valued=True))
        want = 1 if R <= scan.TOPK_TV_TILE else 2
        if n != want:
            fail(f"topk_rows two-valued {what} ([{R}]): {n} device "
                 f"launches a call ({per}), not {want}")
        seen.add(want)
        lines.append(f"{what} [{R}] k {k}: {n:g}")
    if seen != {1, 2}:
        fail(f"K12's two-valued form ran only the {seen}-launch form")
    say(f"[{card}] K12 two-valued == plain word for word on {len(lines)} "
        f"flag sets, device launches a call: " + "; ".join(lines))


def k15_check(what, config, parts, D, Sc, send, stats, before, errs):
    """K15's one call over the shards `parts` (send [Dl, D, Sc, WP] and
    the statistics rows it wrote, `before` them) held to the plain
    version shard by shard, bit for bit."""
    import torch

    from sybil_tpu_torch.parallel import mesh
    if tuple(send.shape[:3]) != (len(parts), D, Sc):
        fail(f"{what}: send buffers of shape {tuple(send.shape)}")
    for d, part in enumerate(parts):
        want, st = torch.empty_like(send[d]), before[d].clone()
        mesh.shuffle_partition_plain(config, part, D, Sc, want, st)
        w = (f"{what} ({config.strategy}, shard {d} of {len(parts)}, D {D}, "
             f"Sc {Sc})")
        check_equal(w + " send", send[d], want, errs["shuffle_partition"])
        check_equal(w + " stats", stats[d, 1:], st[1:],
                    errs["shuffle_partition"])


# K15's corner cases: name -> (the table's scan config fields, local
# shards Dl, shards D, per-owner capacity (None: shuffle_caps'), live
# rows ("first n" as K8 writes them, "scattered" at a rate, shard 3 of a
# case "empty" has none))
K15_AVG = ("weight", dict(hist_min=0, bucket_size=1, num_values=0,
                          discard_min=-10 ** 9, discard_max=10 ** 9))
K15_CASES = {
    "one tile, a shard with no live row": (
        K16_SHAPES["wide"], 8, 8, None, "empty"),
    "a time key, overflow (Sc 4)": (
        dict(group_cols=("host",), aggs=(K15_AVG,), filters=(),
             time_col="time", key_bounds=((0, 10), (0, 5))), 8, 8, 4, 0.9),
    "D = 1": (dict(K16_SHAPES["narrow"], max_groups=3000), 1, 1, None,
              "first"),
    "D = 6": (K16_SHAPES["wide"], 6, 6, None, 0.8),
    "2 of 8 shards, three keys, MISSING": (
        dict(K16_SHAPES["three keys"], max_groups=5000), 2, 8, None,
        "first"),
    "dense, 4 tiles, compact": (
        dict(group_cols=("host",), aggs=(K15_AVG,), filters=(),
             key_bounds=((0, 4000),)), 8, 8, None, 0.5),
    "path 2's table, int64 keys, rows in every tile": (
        K16_SHAPES["narrow"], 8, 8, None, 0.1),
    "path 2's table, overflow": (K16_SHAPES["narrow"], 8, 8, 1000, 0.3),
    "sorted, a histogram's min and max": (
        dict(K16_SHAPES["wide"], force_sorted=True, max_groups=2000), 8, 8,
        None, 0.6),
}


def k15_case_parts(case: str, device, seed: int = 15):
    """One K15 corner case's scan config and its Dl shards' tables as
    scan_core returns them (random lanes, min/max and bucket rows; sorted
    keys over the whole int64 range with MISSING, so both halves of a key
    move its owner) -> (config, parts, D, Sc, time bucket)."""
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.parallel import mesh
    fields, Dl, D, Sc, live = K15_CASES[case]
    o = dict(fields)
    o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o["aggs"])
    config = scan.ScanConfig(no_compact_table=True, **o)
    Seff, caps = mesh.shuffle_caps(config, D)
    K, A = config.n_key_cols, len(config.aggs)
    L, H = 2 + 3 * A, len(scan.hist_aggs(config))
    g = torch.Generator(device=device).manual_seed(seed)
    dense = config.strategy == "dense"
    rows = scan.reduce_space(config)[1] if dense else Seff
    tb = 500

    def rand(*shape, lo=-10 ** 6, hi=10 ** 6):
        return torch.randint(lo, hi, shape, generator=g, device=device)

    parts = []
    for d in range(Dl):
        if live == "first":
            on = torch.arange(rows, device=device) < (d + 1) * rows // (
                Dl + 1)
        elif live == "empty":
            on = torch.full((rows,), d != 3, device=device)
        else:
            on = torch.rand(rows, generator=g, device=device) < live
        sums = rand(rows + (0 if dense else 1), L)
        sums[:rows, :2] = torch.where(on[:, None], rand(rows, 2, lo=0,
                                                         hi=100), 0)
        sums[:rows, 0] = torch.where(on & (sums[:rows, 0] == 0) & (
            sums[:rows, 1] == 0), 1, sums[:rows, 0])
        tab = {"sums": sums, "mins": rand(rows, H), "maxs": rand(rows, H)}
        nouts = [rand(1, lo=0, hi=50) for _ in range(H)]
        part = {"strategy": config.strategy, "nouts": nouts, "dev": device,
                "raw": {"time_bucket": tb}}
        if dense:
            tab["spill"] = rand(1, lo=0, hi=9)
            part.update(k2=tab, hists=[rand(rows, config.aggs[ai].num_values,
                                            lo=0, hi=10 ** 4)
                                       for ai in scan.hist_aggs(config)])
        else:
            keys = torch.randint(-2 ** 63, 2 ** 63 - 1, (rows, K),
                                 generator=g, device=device)
            keys[rand(rows, K, lo=0, hi=10) == 0] = -1
            tab["keys"] = keys
            part.update(k8=tab, spill=rand(1, lo=0, hi=9),
                        pairs=[{"npairs": rand(1, lo=0, hi=50)}
                               for _ in range(H)] or None)
        parts.append(part)
    return config, parts, D, Sc or caps, tb


def k15_edge_checks(card, device, errs) -> None:
    """K15's corner cases (K15_CASES) through one call each on the card,
    held shard by shard to the plain version word for word; the one-tile
    and the look-back forms and overflow must each have run."""
    import torch

    from sybil_tpu_torch.parallel import mesh
    t0 = time.perf_counter()
    lines, seen = [], set()
    for case in K15_CASES:
        config, parts, D, Sc, _ = k15_case_parts(case, device)
        stats = torch.zeros((len(parts), mesh.n_stats(config)),
                            dtype=torch.int64, device=device)
        send = mesh.shuffle_partition(config, parts, D, Sc, stats)
        k15_check(f"K15 case {case!r}", config, parts, D, Sc, send, stats,
                  torch.zeros_like(stats), errs)
        Seff = mesh.shuffle_caps(config, D)[0]
        over = int(stats[:, 2].sum().item())
        seen.add("one tile" if Seff <= 1024 else "look-back")
        if over:
            seen.add("overflow")
        lines.append(f"{case} ({config.strategy}, {len(parts)} of {D} "
                     f"shards, {Seff} rows, Sc {Sc}, overflow {over})")
    if seen != {"one tile", "look-back", "overflow"}:
        fail(f"K15's corner cases ran only {sorted(seen)}")
    say(f"[{card}] K15 == plain word for word on {len(lines)} corner "
        "cases: " + "; ".join(lines)
        + f" ({time.perf_counter() - t0:.2f} s)")


def mesh_checked(errs, label_of):
    """Wrap the mesh path's wrappers (K15 over every shard; K16's
    shuffle_keys and shuffle_reduce over every owner, shuffle_unpack; K12
    as the mesh calls it; K3 and K10 on a merged table) so each call made
    while label_of() names a spec (the checked run) also runs its plain
    version on the same inputs on the card and is held to it bit for bit
    (errs), and keep each one's arguments per spec label (the first
    batch's), with the sharded_scan calls'.  Calls while label_of() is empty
    (the timed runs) go to the kernels alone.
    -> (captured {(name, label): args}, undo)."""
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.parallel import mesh
    captured = {}
    real = {n: getattr(mesh, n) for n in (
        "shuffle_partition", "shuffle_keys", "shuffle_reduce",
        "shuffle_unpack", "topk_rows", "sharded_scan")}
    real_k3, real_k10 = scan.dense_pack, scan.sorted_pack
    real_k2 = scan.dense_scan

    def k15(config, parts, D, Sc, stats):
        before = stats.clone()
        send = real["shuffle_partition"](config, parts, D, Sc, stats)
        k15_check(f"shuffle_partition {label_of()}", config, parts, D, Sc,
                  send, stats, before, errs)
        captured.setdefault(("shuffle_partition", label_of()),
                            (config, parts, D, Sc, stats))
        return send

    def k16k(config, recv):
        got = real["shuffle_keys"](config, recv)
        k16_keys_check(f"shuffle_keys {label_of()} {list(recv.shape)}",
                       config, recv, got, errs)
        captured.setdefault(("shuffle_keys", label_of()), (config, recv))
        return got

    def k16(config, recv, src, order, off, merged, flive, stats):
        real["shuffle_reduce"](config, recv, src, order, off, merged, flive,
                               stats)
        k16_reduce_check(f"shuffle_reduce {label_of()}", config, recv, src,
                         order, off, merged, flive, stats, errs)
        captured.setdefault(("shuffle_reduce", label_of()),
                            (config, recv, src, order, off, merged, flive,
                             stats))

    def k16u(config, flat, flive, top, stats, S):
        got = real["shuffle_unpack"](config, flat, flive, top, stats, S)
        k16_unpack_check(f"shuffle_unpack {label_of()}", config, flat, flive,
                         top, stats, S, got, errs)
        captured[("shuffle_unpack", label_of())] = (config, flat, flive, top,
                                                    stats, S)
        return got

    def k12(score, k, two_valued=False):
        got = real["topk_rows"](score, k, two_valued=two_valued)
        check_equal(f"topk_rows {label_of()} (two-valued {two_valued}, "
                    f"[{score.numel()}], k {k})", got,
                    scan.topk_rows_plain(score, k), errs["topk_rows"])
        captured[("topk_rows", label_of())] = (score, k)
        return got

    def k3(config, k2, hists, nouts, main, R, hll=None, time_bucket=1):
        if "keys" not in k2:
            return real_k3(config, k2, hists, nouts, main, R, hll,
                           time_bucket)
        want = main.clone()
        real_k3(config, k2, hists, nouts, main, R, hll, time_bucket)
        scan.dense_pack_plain(config, k2, hists, nouts, want, R, hll,
                              time_bucket)
        check_equal(f"dense_pack keyed {label_of()} (S {config.dense_slots})",
                    main, want, errs["dense_pack"])
        captured[("dense_pack", label_of())] = (config, k2, hists, nouts,
                                                main, R)

    def k10(config, k8, spill, pairs, nouts, main, R, overflow=None):
        if overflow is None:
            return real_k10(config, k8, spill, pairs, nouts, main, R)
        want = main.clone()
        got = real_k10(config, k8, spill, pairs, nouts, main, R, overflow)
        w = scan.sorted_pack_plain(config, k8, spill, pairs, nouts, want, R,
                                   overflow)
        what = f"sorted_pack merged {label_of()}"
        keep = torch.ones(main.shape[0], dtype=torch.bool, device=main.device)
        if got["score"] is not None:
            # under the device prune the prefix is K12's gather's to write
            keep[1:1 + scan.table_prefix(config)] = False
        check_equal(f"{what} main", main[keep], want[keep],
                    errs["sorted_pack"])
        check_equal(f"{what} table", got["table"], w["table"],
                    errs["sorted_pack"])
        if got["score"] is not None:
            check_equal(f"{what} score", got["score"], w["score"],
                        errs["sorted_pack"])
        captured[("sorted_pack", label_of())] = (config, k8, spill, pairs,
                                                 nouts, main, R, overflow)
        return got

    def shard(*args):
        captured[("sharded_scan", label_of())] = args
        return real["sharded_scan"](*args)

    def k2(config, cols, nrec, filter_vals=None, bitsets=(),
           time_bucket=1, form=None, set_masks=None):
        # the first shard's windowed launch, for k2w_edge_checks
        if scan.windowed(config):
            captured.setdefault(("dense_scan", label_of()), (
                config, cols, nrec, filter_vals, bitsets, time_bucket,
                set_masks))
        return real_k2(config, cols, nrec, filter_vals, bitsets,
                       time_bucket, form, set_masks)

    def only_checked(fn, kernel):
        def call(*args, **kwargs):
            return (fn if label_of() else kernel)(*args, **kwargs)
        return call

    for name, fn in (("shuffle_partition", k15), ("shuffle_keys", k16k),
                     ("shuffle_reduce", k16), ("shuffle_unpack", k16u),
                     ("topk_rows", k12), ("sharded_scan", shard)):
        setattr(mesh, name, only_checked(fn, real[name]))
    scan.dense_pack = only_checked(k3, real_k3)
    scan.sorted_pack = only_checked(k10, real_k10)
    scan.dense_scan = only_checked(k2, real_k2)

    def undo():
        for name, fn in real.items():
            setattr(mesh, name, fn)
        scan.dense_pack, scan.sorted_pack = real_k3, real_k10
        scan.dense_scan = real_k2
    return captured, undo


def mesh_phase(card, specs, errs, launches, device):
    """The mesh scan on the card: each spec's query through run_query at
    -data-shards 8 (one batch; the config-1 spec also through the CLI),
    first once with every mesh kernel held to its plain version
    (mesh_checked), then cold and warm walls beside the unsharded query's
    warm walls, the launches per mesh query (K15, K16's entries, the
    per-shard scan kernels once per shard), each answer equal to the
    unsharded one and to the spec's numpy check.  Then the exchange's
    distributed form over an NCCL group of world size 1 against the local
    form.  Launches of the timed warm mesh queries are added to
    `launches`.  -> the kernel table's rows."""
    import torch

    from sybil_tpu_torch.ops import kernels, residency
    from sybil_tpu_torch.query.engine import run_query
    current = [""]
    captured, undo = mesh_checked(errs, lambda: current[0])
    try:
        for sp in specs:
            label, table, params, qflags = (sp["label"], sp["table"],
                                            sp["params"], sp["flags"])
            mflags = dataclasses.replace(qflags, data_shards=MESH_D)
            run_query(table, params, qflags)          # resident columns
            warm_u = []
            for _ in range(5):
                t0 = time.perf_counter()
                qr_u = run_query(table, params, qflags)
                warm_u.append(time.perf_counter() - t0)
            current[0] = label
            t0 = time.perf_counter()
            qr_c = run_query(table, params, dataclasses.replace(mflags))
            checked_wall = time.perf_counter() - t0
            current[0] = ""
            if sp.get("relaxed"):
                sp["relaxed"](qr_c, qr_u)
            elif mesh_snapshot(qr_c) != mesh_snapshot(qr_u):
                fail(f"mesh {label}: the 8-shard answer differs from the "
                     f"unsharded one")
            residency.CACHE.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_query(table, params, dataclasses.replace(mflags))
            cold = time.perf_counter() - t0
            kernels.reset_launches()
            warm = []
            for _ in range(5):
                t0 = time.perf_counter()
                qr_m = run_query(table, params, dataclasses.replace(mflags))
                warm.append(time.perf_counter() - t0)
            lw = kernels.snapshot()
            tally(launches, lw)
            per = {k: n / 5 for k, n in lw.items() if n}
            nb = sp["batches"]
            for k, n in dict(sp["expect"], shuffle_partition=1,
                             shuffle_keys=1, shuffle_reduce=1,
                             shuffle_unpack=1).items():
                if lw[k] != 5 * n * nb:
                    fail(f"mesh {label}: expected {k} {n}x per batch over "
                         f"{nb} batch(es): {per}")
            if lw["topk_rows"] < 5 * nb:
                fail(f"mesh {label}: K12 never compacted: {per}")
            if sp.get("relaxed"):
                sp["relaxed"](qr_m, qr_u)
            elif mesh_snapshot(qr_m) != mesh_snapshot(qr_u):
                fail(f"mesh {label}: the warm 8-shard answer differs from "
                     f"the unsharded one")
            if sp.get("check"):
                sp["check"](qr_m)
            say(f"[{card}] mesh {label}: -data-shards {MESH_D} == unsharded"
                + (" == numpy" if sp.get("check") else "")
                + f"; launches per query {per}; cold wall "
                f"{cold * 1e3:.3f} ms, warm wall median of 5 "
                f"{median(warm) * 1e3:.3f} ms (walls "
                f"{[round(x * 1e3, 3) for x in warm]}); unsharded warm "
                f"median of 5 {median(warm_u) * 1e3:.3f} ms (walls "
                f"{[round(x * 1e3, 3) for x in warm_u]}); checked run "
                f"{checked_wall * 1e3:.1f} ms")
            if sp.get("phases"):
                phase_lines(card, f"mesh {label}",
                            lambda: run_query(table, params,
                                              dataclasses.replace(mflags)),
                            residency.CACHE.clear)
    finally:
        undo()
    for sp in specs:
        for name in ("shuffle_partition", "shuffle_keys", "shuffle_reduce",
                     "shuffle_unpack"):
            if (name, sp["label"]) not in captured:
                fail(f"mesh {sp['label']}: {name} was never checked")
    k16_edge_checks(card, device, errs)
    k15_edge_checks(card, device, errs)
    shards = [(f"mesh {lb}, first shard", *args) for (name, lb), args in
              captured.items() if name == "dense_scan"]
    if not shards:
        fail("mesh: no shard took K2's windowed form")
    k2w_edge_checks(card, device, errs, shards, cases=False)
    k12_edge_checks(card, device, errs, [
        (f"mesh {lb}", *args) for (name, lb), args in captured.items()
        if name == "topk_rows"])
    mesh_nccl_check(card, captured, device)
    return mesh_kernel_rows(card, captured, device)


def mesh_nccl_check(card, captured, device):
    """The exchange's distributed form (torch.distributed's
    all_to_all_single and all_gather_into_tensor) over an NCCL process
    group of world size 1, on a localhost TCP store: a whole sharded scan
    of the dense and the sorted captured batch through it, packed, equal
    word for word to the local form's; then the process group is
    destroyed.  Multi-rank NCCL needs more cards than this machine has."""
    import socket

    import torch
    import torch.distributed as dist

    from sybil_tpu_torch.ops.scan import pack_parts
    from sybil_tpu_torch.parallel import mesh
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        nccl = mesh.Mesh(MESH_D, dist.group.WORLD)
        local = mesh.Mesh(MESH_D)
        done = []
        for (name, label), args in captured.items():
            if name != "sharded_scan" or label not in ("config 3 -loghist",
                                                       "path 2"):
                continue
            cfg, _, cols, nrec, fv, bits, tb, sa = args
            mains = []
            for m in (local, nccl):
                parts = mesh.sharded_scan(cfg, m, cols, nrec, fv, bits, tb,
                                          sa)
                packed = pack_parts(cfg, parts)
                mains.append(packed["main"])
            torch.cuda.synchronize()
            if not torch.equal(mains[0], mains[1]):
                fail(f"mesh {label}: the NCCL exchange's packed answer "
                     f"differs from the local exchange's")
            done.append(label)
        if len(done) != 2:
            fail(f"mesh: NCCL check ran on {done}")
        # the exchange alone on a random send buffer
        g = torch.Generator(device=device).manual_seed(5)
        send = torch.randint(-2 ** 40, 2 ** 40, (MESH_D, MESH_D, 64, 9),
                             generator=g, device=device)
        if not torch.equal(nccl.all_to_all(send), local.all_to_all(send)):
            fail("mesh: NCCL all_to_all differs from the local transpose")
        if not torch.equal(nccl.all_gather(send), local.all_gather(send)):
            fail("mesh: NCCL all_gather differs from the local form")
    finally:
        dist.destroy_process_group()
    say(f"[{card}] mesh: the exchange over NCCL (world size 1) == the "
        f"local exchange: {', '.join(done)} packed word for word, and "
        f"all_to_all / all_gather on a random [8, 8, 64, 9] buffer")


def k12_row(card, captured, label):
    """K12's two-valued form at a mesh query's captured compaction: events
    and device time, device launches a call, the plain version and
    torch.topk -> the kernel table's row.  Bound: the flags read once,
    the k indices written; per flag a load, a test and the rank's add."""
    import torch

    from sybil_tpu_torch.ops import scan
    score, k = captured[("topk_rows", label)]
    R = score.numel()

    def k12():
        scan.topk_rows(score, k, two_valued=True)
    ms = cuda_ms(k12, iters=20)
    dms = queued_ms(k12, iters=20)
    nl, per = device_launches(k12)
    pms = cuda_ms(lambda: scan.topk_rows_plain(score, k), iters=5)
    lib_ms = cuda_ms(lambda: torch.topk(score, k), iters=5)
    say(f"[{card}] topk_rows two-valued, mesh {label} (int32 [{R}], k {k}, "
        f"{int(score.sum().item())} ones): device {dms:.4f} ms, {nl} device "
        f"launches a call ({per}); events {ms:.4f} ms; plain {pms:.4f} ms; "
        f"torch.topk {lib_ms:.4f} ms")
    return ("topk_rows", f"{label}, the compaction: two-valued int32 [{R}], "
            f"k {k}", "sybil_tpu/parallel/mesh.py:291", ms, pms,
            R * 4 + k * 4, R * 3, lib_ms)


def k15_row(card, config, parts, D, Sc, stats, label):
    """K15 over a mesh query's captured batch (every shard in one call):
    events and device time, its device launches a call (a memset and one
    kernel; at most a memset and two above one tile), the plain version
    and the two torch calls that place the same shards' rows (a stable
    argsort of the owners keyed shard x (D + 1) + owner, an index_copy_
    of the payload rows) -> the kernel table's row; per-shard figures are
    a batch's over its shards."""
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.parallel import mesh
    K, A, hist_ais, nv_total, n_sum, WP = mesh.payload_spec(config)
    Dl, Seff = len(parts), config.table_slots
    device = stats.device
    t0 = time.perf_counter()

    def k15():
        mesh.shuffle_partition(config, parts, D, Sc, stats)
    dms = queued_ms(k15, iters=50)
    nl, per = recorded_launches(k15)
    most = 2 if Seff <= 1024 else 3
    if nl is None or nl > most:
        fail(f"K15 at {label}: {nl} device operations a call ({per}), "
             f"more than {most}")
    st2 = stats.clone()
    s2 = torch.empty((Dl, D, Sc, WP), dtype=torch.int64, device=device)

    def plain():
        for d, part in enumerate(parts):
            mesh.shuffle_partition_plain(config, part, D, Sc, s2[d], st2[d])
    pms = cuda_ms(plain, iters=5)
    pays, keys = [], []
    for d, part in enumerate(parts):
        payload, live = mesh.build_payload_plain(config, part)
        owner = torch.where(live, mesh.mix_keys_plain(payload[:, :K]) % D,
                            D)
        pays.append(payload)
        keys.append(owner + d * (D + 1))
    payload, key = torch.cat(pays), torch.cat(keys)
    # each shard's live rows per owner, and those placed (within Sc)
    per_owner = torch.bincount(key, minlength=Dl * (D + 1)).view(
        Dl, D + 1)[:, :D]
    nlive = int(per_owner.sum().item())
    placed = int(per_owner.clamp(max=Sc).sum().item())
    buf = torch.zeros_like(payload)
    dst = torch.arange(payload.shape[0], device=device)

    def lib():
        buf.index_copy_(0, dst, payload[torch.argsort(key, stable=True)])
    # both host-bound at config 3's shape: timed in turns (K15, torch,
    # torch, K15) twice, the median of each, as one host stall moves a
    # single reading by tens of microseconds
    ev = {k15: [], lib: []}
    for fn in (k15, lib, lib, k15) * 2:
        ev[fn].append(cuda_ms(fn, iters=50))
    ms, lib_ms = median(ev[k15]), median(ev[lib])
    del pays, keys, payload, buf
    dense = config.strategy == "dense"
    Sr = scan.reduce_space(config)[1] if dense else Seff
    H = len(scan.hist_aggs(config))
    # what this run's data needs: every row's count and samples words
    # (its live test), a live row's keys (sorted: read for its owner), a
    # placed row's other lanes, min/max and bucket rows; every send
    # buffer and statistics word written.  Per row the live test; per
    # live row the hash over 2K halves and the finaliser, (dense) each
    # key's digit by a division and a modulo; a word a placed row's word
    nbytes = (Dl * Sr * 2 * 8 + (0 if dense else nlive * K * 8)
              + placed * (3 * A + 2 * H + nv_total) * 8
              + Dl * (D * Sc * WP + stats.shape[1]) * 8)
    ops = Dl * Seff * 4 + nlive * (6 * K + 6 + (60 * K if dense else 0)) \
        + placed * WP
    say(f"[{card}] shuffle_partition, mesh {label}, {Dl} shards in one "
        f"call: device {dms:.4f} ms ({dms / Dl:.4f} a shard), events "
        f"{ms:.4f} ms ({ms / Dl:.4f} a shard); the argsort and index_copy_ "
        f"over the same shards {lib_ms:.4f} ms ({lib_ms / Dl:.4f} a "
        f"shard); plain {pms:.4f} ms; bound "
        f"{max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f}"
        f" ms; {nl} device operations a call ({per}); this row "
        f"{time.perf_counter() - t0:.2f} s")
    return ("shuffle_partition", f"{label}, a mesh batch: {Dl} shards in "
            f"one call ({Seff} table rows each, {nlive} live in all, D {D}, "
            f"Sc {Sc}, WP {WP})", "sybil_tpu/parallel/mesh.py:88", ms, pms,
            nbytes, ops, lib_ms)


def mesh_kernel_rows(card, captured, device) -> list:
    """Each mesh kernel at the captured shapes: K15 over config 3
    -loghist's 8 shards (dense, hist lanes) and path 2's (sorted, the
    100,000-slot tables) in one call each, K16's entries, K12 two-valued
    and the unpack at path 2's owner and compaction, K3's keyed form at
    config 3 -loghist; beside
    the plain versions and one torch call each where there is one.  ->
    the kernel table's rows (name, shape, replaces, ms, plain ms, bytes,
    operations, library ms)."""
    import torch

    from sybil_tpu_torch.ops import scan
    from sybil_tpu_torch.parallel import mesh
    rows = []
    for label in ("config 3 -loghist", "path 2"):
        config, parts, D, Sc, stats = captured[("shuffle_partition", label)]
        rows.append(k15_row(card, config, parts, D, Sc, stats, label))
        K, A, hist_ais, nv_total, n_sum, WP = mesh.payload_spec(config)

        config, recv = captured[("shuffle_keys", label)]
        Dl, N, _ = recv.shape
        ms = cuda_ms(lambda: mesh.shuffle_keys(config, recv), iters=50)
        pms = cuda_ms(lambda: mesh.shuffle_keys_plain(config, recv),
                      iters=5)
        # one torch call: the masked transpose of every owner's keys, the
        # live mask prebuilt
        flat_r = recv.reshape(Dl * N, WP)
        rlive = (flat_r[:, K] > 0) | (flat_r[:, K + 1] > 0)
        lib_ms = cuda_ms(lambda: torch.where(
            rlive[None, :], flat_r[:, :K].t(), scan.SENTINEL).contiguous(),
            iters=20)
        nl = int(rlive.sum().item())
        front, src, off = mesh.shuffle_keys(config, recv)
        M = src.numel()
        # its device work from the profiler, late (LATE_PROFILES): the
        # call waits on the device for M, so a queue behind a sleep kernel
        # cannot time it
        LATE_PROFILES.append((
            f"shuffle_keys, mesh {label}",
            lambda config=config, recv=recv: mesh.shuffle_keys(config, recv)))
        say(f"[{card}] shuffle_keys, mesh {label}: events {ms:.4f} ms; {M} "
            f"of {Dl * N} rows kept ({nl} live)")
        # every row's count and samples words read, a live row's K keys
        # read; src, off and the sort operands the call returns written:
        # the packed key at its width, else the K + 1 lanes
        out_b = (M * front["key"].element_size() if front["key"] is not None
                 else (K + 1) * M * 8)
        rows.append(("shuffle_keys", f"{label}, a mesh batch ({Dl} owners of "
                     f"{N} rows, {nl} live, {M} kept)",
                     "sybil_tpu/parallel/mesh.py:156", ms, pms,
                     Dl * N * 2 * 8 + nl * K * 8 + M * 4 + (Dl + 1) * 4
                     + out_b, Dl * N * 3 + M * K, lib_ms))
        lanes = [front["key"]] if front["key"] is not None else \
            list(front["keys"])
        for lane in lanes:
            say(f"[{card}] sorts, mesh {label}: a stable torch.sort of "
                f"{'the packed key' if front['key'] is not None else 'a lane'}"
                f", {lane.dtype} [{M}] "
                f"{cuda_ms(lambda: torch.sort(lane, stable=True)):.4f} ms "
                f"(bound {sort_bound_ms(M, lane.element_size()):.4f} ms)")

        config, recv, src, order, off, merged, flive, stats_r = \
            captured[("shuffle_reduce", label)]
        M = src.numel()
        cap = merged.shape[1]

        def k16():
            mesh.shuffle_reduce(config, recv, src, order, off, merged, flive,
                                stats_r)
        ms = cuda_ms(k16, iters=50)
        dms = queued_ms(k16, iters=50)
        m2, f2, s2 = (torch.empty_like(merged), torch.empty_like(flive),
                      stats_r.clone())
        pms = cuda_ms(lambda: mesh.shuffle_reduce_plain(
            config, recv, src, order, off, m2, f2, s2), iters=5)
        # one torch call: index_add_ of the sorted summed lanes by each
        # row's segment, owner-major (gid and the sorted rows prebuilt),
        # as row 5's yardstick
        srows = recv.reshape(-1, WP)[src.to(torch.int64)[
            scan.sorted_perm(order)]]
        slive = (srows[:, K] > 0) | (srows[:, K + 1] > 0)
        skeys = torch.where(slive[:, None], srows[:, :K], scan.SENTINEL)
        bnd = off.tolist()
        differs = torch.ones(M, dtype=torch.bool, device=device)
        differs[1:] = (skeys[1:] != skeys[:-1]).any(dim=1)
        differs[torch.tensor(bnd[:-1], device=device)] = True
        gid = torch.cumsum(differs.to(torch.int64), 0) - 1
        lanes = srows[:, K:K + n_sum].contiguous()
        ng_all = int(gid[-1].item()) + 1
        lib_ms = cuda_ms(lambda: torch.zeros(
            (ng_all, n_sum), dtype=torch.int64, device=device).index_add_(
                0, gid, lanes), iters=20)
        ng = int(stats_r[:, 0].sum().item())
        nl = int(slive.sum().item())
        del srows, skeys, lanes
        # every kept position walked: p (and base) and src read, a live
        # row's WP words gathered (its keys and live words among them), a
        # dead row's two live words; off read; the merged tables and
        # their live flags written.  Per walked position: the gather and
        # the K-key boundary test; per live row: a 5-step warp-run reduce
        # a word
        nbytes = (M * 8 * (1 if order["base"] is None else 2) + M * 4
                  + nl * WP * 8 + (M - nl) * 2 * 8 + (Dl + 1) * 4
                  + Dl * cap * WP * 8 + Dl * cap * 4 + Dl * 8)
        ops = M * (8 + 4 * K) + nl * 12 * (n_sum + 2 * A)
        say(f"[{card}] shuffle_reduce, mesh {label}: device {dms:.4f} ms, "
            f"events {ms:.4f} ms; {M} kept positions walked over {Dl} "
            f"owners; bound "
            f"{max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3:.4f}"
            f" ms; index_add_ {lib_ms:.4f} ms")
        say(f"[{card}] shuffle_reduce, mesh {label}, launches a batch: "
            f"{profiled_kernels(k16)}")
        rows.append(("shuffle_reduce", f"{label}, a mesh batch ({Dl} owners, "
                     f"{M} kept rows, {nl} live, {ng} groups, cap {cap}, WP "
                     f"{WP})", "sybil_tpu/parallel/mesh.py:146", ms, pms,
                     nbytes, ops, lib_ms))

        def loop(config=config, recv=recv, merged=merged, flive=flive,
                 stats_r=stats_r):
            mesh.merge_owners(config, recv, merged, flive, stats_r)
        LATE_PROFILES.append((f"the owner loop (merge_owners), mesh {label}",
                              loop))
        say(f"[{card}] the owner loop (merge_owners), mesh {label}: events "
            f"{cuda_ms(loop, iters=20):.4f} ms a mesh batch")

        config, flat, flive_a, top, stats_a, S = captured[
            ("shuffle_unpack", label)]
        kk = top.numel()
        rows.append(k12_row(card, captured, label))

        def k16u():
            mesh.shuffle_unpack(config, flat, flive_a, top, stats_a, S)
        ms = cuda_ms(k16u, iters=50)
        dms = queued_ms(k16u, iters=50)
        pms = cuda_ms(lambda: mesh.shuffle_unpack_plain(
            config, flat, flive_a, top, stats_a, S), iters=5)
        lib_ms = cuda_ms(lambda: torch.index_select(flat, 0,
                                                    top.to(torch.int64)),
                         iters=20)
        say(f"[{card}] shuffle_unpack, mesh {label}: device {dms:.4f} ms, "
            f"events {ms:.4f} ms; index_select {lib_ms:.4f} ms; launches "
            f"{profiled_kernels(k16u)}")
        L = 2 + 3 * A
        nbytes = (kk * 4 + kk * 4 + kk * WP * 8 + stats_a.numel() * 8
                  + S * (K + L + 2 * A + nv_total) * 8 + L * 8
                  + stats_a.shape[1] * 8)
        rows.append(("shuffle_unpack", f"{label}, the final table ({S} rows "
                     f"of {kk} gathered, WP {WP})",
                     "sybil_tpu/parallel/mesh.py:197", ms, pms, nbytes,
                     S * (4 + WP), lib_ms))

    rows.append(k12_row(card, captured, "config 5 partition 1"))
    config, k2, hists, nouts, main, R = captured[("dense_pack",
                                                  "config 3 -loghist")]
    want = main.clone()
    ms = cuda_ms(lambda: scan.dense_pack(config, k2, hists, nouts, main, R),
                 iters=50)
    pms = cuda_ms(lambda: scan.dense_pack_plain(config, k2, hists, nouts,
                                                want, R), iters=5)
    S = config.dense_slots
    A = len(config.aggs)
    nv = sum(h.shape[1] for h in hists)
    lay = scan.packed_layout(config, R)
    rows.append(("dense_pack", f"config 3 -loghist at {MESH_D} shards, the "
                 f"keyed form ({S} rows)", "sybil_tpu/ops/scan.py:1865", ms,
                 pms, S * (config.n_key_cols + 2 + 5 * A + nv) * 8
                 + lay["rows"] * lay["W"] * 8, S * 16, None))
    for name, what, _, ms, pms, *_ in rows:
        say(f"[{card}] {name} ({what}): {ms:.4f} ms (plain {pms:.4f} ms)")
    return rows


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the row store: -read-log over an undigested WAL tail (K3's keyed form of
# a pseudo-block's own table), ingest and digest
# ---------------------------------------------------------------------------

RS_LOGS = 16                    # logs of the uptime table's tail
RS_LOG_ROWS = 65536             # records a log: the ingest flushes a log a
                                # CHUNK_SIZE records
RS_SETS_ROWS = 65536            # the sets table's tail (one log)
# the tail's hosts: bench.py's five and two the digested blocks lack
RS_HOSTS = HOSTS + ["www.bing.com", "news.ycombinator.com"]
RS_WEIGHT = 1000                # a weight past the blocks' (1, 10, 100)
# the -read-log queries on the uptime table (flags after -dir, -table)
RS_C1 = ["-group", "host", "-int", "ping", "-op", "avg"]
RS_ARGV = {
    "config 1": RS_C1,
    "config 3 -loghist": ["-group", "host", "-int", "ping", "-op", "hist",
                          "-str-filter", "status:eq:200", "-loghist"],
    "1 h rollup": RS_C1 + ["-time", "-time-bucket", str(C4_BUCKET),
                           "-time-col", "time"],
    "path 1 (-tdigest)": P1_ARGV,
    "distinct index_int": ["-group", "host", "-distinct", "index_int"],
    # the tail's weight RS_WEIGHT spills the blocks' dense key bound: the
    # sorted retry of a pseudo-block
    "config 1 by host and weight": ["-group", "host,weight", "-int", "ping",
                                    "-op", "avg"],
    f"config 1 -data-shards {MESH_D}": RS_C1 + ["-data-shards", str(MESH_D)],
}


def rowstore_tail(start: int, n: int, pmax: int):
    """n rows of bench.py's uptime generator continued at row `start` (its
    seed rule 1337 + start, 1M-row steps), then: hosts 5 and 6 of RS_HOSTS
    (absent from the blocks) at rows j % 97 == 5 and 50, pings above the
    blocks' max `pmax` (pmax + 1 .. pmax + 40) at rows j % 1009 == 7, and
    weight RS_WEIGHT at rows j % 4099 == 11.  -> (JSON lines, {"host"
    (RS_HOSTS indices), "status", "ping", "weight", "time",
    "index_int"})."""
    import numpy as np
    rng = np.random.default_rng(BENCH_SEED + start)
    parts = {k: [] for k in ("host", "status", "ping", "weight", "time")}
    for s in range(start, start + n, STEP):
        m = min(STEP, start + n - s)
        parts["host"].append(rng.integers(0, 5, m))
        parts["status"].append(rng.integers(0, 5, m))
        parts["ping"].append(np.abs(rng.normal(60, 20, m)).astype(np.int64))
        parts["weight"].append(rng.choice([1, 10, 100], m).astype(np.int64))
        parts["time"].append(BENCH_NOW + rng.integers(-2419200, 2419200, m))
    arr = {k: np.concatenate(v) for k, v in parts.items()}
    j = np.arange(n)
    arr["host"][j % 97 == 5] = 5
    arr["host"][j % 97 == 50] = 6
    hi = j % 1009 == 7
    arr["ping"][hi] = pmax + 1 + (j[hi] // 1009) % 40
    arr["weight"][j % 4099 == 11] = RS_WEIGHT
    arr["index_int"] = np.arange(start, start + n, dtype=np.int64)
    lines = [f'{{"host":"{RS_HOSTS[h]}","status":"{STATII[st]}","ping":{p},'
             f'"weight":{w},"time":{t},"index_int":{i}}}'
             for h, st, p, w, t, i in zip(*(arr[k].tolist() for k in (
                 "host", "status", "ping", "weight", "time",
                 "index_int")))]
    return lines, arr


def sets_tail(start: int, n: int):
    """n rows of the sets table's generator (uptime_set_columns) continued
    at row `start`.  -> (JSON lines, {"host", "ping", "index_int"})."""
    ints, strs, sets, _, host = uptime_set_columns(n, start)
    lines = [json.dumps({"ping": p, "weight": w, "time": t, "index_int": i,
                         "status": st, "host": h, "index_str": si,
                         "groups": g})
             for p, w, t, i, st, h, si, g in zip(
                 *(ints[k].tolist() for k in ("ping", "weight", "time",
                                              "index_int")),
                 strs["status"], strs["host"], strs["index_str"],
                 sets["groups"])]
    return lines, {"host": host, "ping": ints["ping"],
                   "index_int": ints["index_int"]}


def keyed_edge_configs():
    """Synthetic configs for K3's keyed form of a pseudo-block's own table:
    label -> ScanConfig (no_compact_table, one [1, 65536] block)."""
    from sybil_tpu_torch.ops import scan
    hist = dict(hist_min=0, bucket_size=10, num_values=14, discard_min=0,
                discard_max=1400)
    avg = dict(hist_min=0, bucket_size=1, num_values=0,
               discard_min=-10 ** 9, discard_max=10 ** 9)

    def cfg(**o):
        o["aggs"] = tuple(scan.AggSpec(c, **kw) for c, kw in o.get("aggs",
                                                                    ()))
        return scan.ScanConfig(filters=(), no_compact_table=True, **o)
    return {
        "one key, MISSING rows, compact Sc": cfg(
            group_cols=("host",), aggs=(("ping", avg),),
            key_bounds=((0, 5),)),
        "three keys, MISSING and negative values": cfg(
            group_cols=("host", "user", "neg"), aggs=(("ping", avg),),
            key_bounds=((0, 5), (0, 37), (-3, 6))),
        "a time key (digit 0 at (min - 1) x bucket)": cfg(
            group_cols=("host",), aggs=(("ping", avg),), time_col="time",
            key_bounds=((-2, 12), (0, 5))),
        "no keys (one zero column)": cfg(group_cols=(),
                                         aggs=(("ping", avg),)),
        "a hist with outliers beside an avg (sentinel min/max)": cfg(
            group_cols=("host",), aggs=(("ping", hist), ("weight", avg)),
            key_bounds=((0, 5),), track_outliers=True),
        "the device HLL sections": cfg(
            group_cols=("host",), distinct_cols=("user",), hll=True,
            key_bounds=((0, 5),)),
        "a weight column, no compact Sc (g + 1 = slots)": cfg(
            group_cols=("user",), aggs=(("ping", avg),),
            weight_col="weight", key_bounds=((0, 126),)),
    }


def keyed_edge_checks(device, errs) -> list:
    """K3's keyed form against its plain version, word for word, on the
    keyed_edge_configs over one synthetic pseudo-block.  -> labels."""
    import numpy as np
    import torch

    from sybil_tpu_torch.ops import kernels, scan
    rng = np.random.default_rng(11)
    C = 65536

    def col(v, p=0.95):
        return (torch.from_numpy(np.asarray(v, np.int64).reshape(1, C))
                .to(device),
                torch.from_numpy(rng.random((1, C)) < p).to(device))
    cols = {"host": col(rng.integers(-1, 6, C)),
            "ping": col(rng.integers(0, 200, C)),
            "weight": col(rng.choice([0, 1, 10, 100], C)),
            "user": col(rng.integers(0, 130, C)),
            "neg": col(rng.integers(-4, 4, C)),
            "time": col(rng.integers(-300, 1300, C))}
    nrec = torch.tensor([C - 17], dtype=torch.int32, device=device)
    fv = torch.zeros(0, dtype=torch.int64, device=device)
    labels = []
    for label, cfg in keyed_edge_configs().items():
        parts = scan.scan_core(cfg, cols, nrec, fv, (), 100, {})
        if parts["strategy"] != "dense":
            fail(f"keyed edge {label}: not the dense strategy")
        lay = scan.packed_layout(cfg, C)
        main = torch.full((lay["rows"], lay["W"]), FILL, dtype=torch.int64,
                          device=device)
        lo, hi = scan.outlier_rows(cfg, C)
        main[lo:hi] = 0
        before = kernels.LAUNCHES["dense_keyed"]
        scan.dense_pack(cfg, parts["k2"], parts["hists"], parts["nouts"],
                        main, C, parts["hll"], 100)
        if kernels.LAUNCHES["dense_keyed"] != before + 1:
            fail(f"keyed edge {label}: dense_keyed did not launch")
        want = main.clone()
        scan.dense_pack_plain(cfg, parts["k2"], parts["hists"],
                              parts["nouts"], want, C, parts["hll"], 100)
        check_equal(f"K3 keyed edge {label}", main, want,
                    errs["dense_keyed"])
        labels.append(f"{label} (slots {cfg.dense_slots}, Sc "
                      f"{scan.reduce_space(cfg)[1]})")
    return labels


def json_rows(out: str):
    """A -json answer as an order-free value: a list of rows sorted by
    their JSON text, or a time rollup's {bucket: sorted rows}."""
    v = json.loads(out)
    if isinstance(v, dict):
        return {k: sorted(json.dumps(r, sort_keys=True) for r in rows)
                for k, rows in v.items()}
    return sorted(json.dumps(r, sort_keys=True) for r in v)


def rowstore_phase(card, root, table, up, stbl, sarr, errs, launches,
                   device):
    """-read-log on copies of the uptime and sets tables, each with an
    undigested tail ingested through the port's `ingest -skip-compact`:
    RS_LOGS logs of RS_LOG_ROWS records (rowstore_tail) on the uptime
    copy, RS_SETS_ROWS on the sets copy.  Every RS_ARGV query and S1 run
    through the CLI with -read-log against numpy over the digested rows
    and the tail, each log decoded natively, K3's keyed form held to its
    plain version on every pseudo-block; the launches of the rowstore
    phase (K2 and K3's keyed form on `device`) and the sorted retry are
    counted.  Then the walls with the rowstore phase, K3's keyed form on
    synthetic configs, `python -m sybil_tpu_torch digest` of both tails,
    and the same queries without -read-log, equal to the answers before
    the digest.  The CLI queries' launches are added to `launches`.
    -> the kernel table's rows."""
    import numpy as np
    import torch

    from sybil_tpu_torch import columnar, native, rowstore
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.ops import kernels, residency, scan
    from sybil_tpu_torch.query import engine
    from sybil_tpu_torch.query.engine import run_query
    from sybil_tpu_torch.table import Table

    if not native.available():
        fail("row store: the native WAL decoder is not available (g++)")
    dev_arg = device.type
    t0 = time.perf_counter()
    rroot = os.path.join(root, "rs_up")
    sroot = os.path.join(root, "rs_sets")
    shutil.copytree(os.path.join(table.flags.dir, "uptime"),
                    os.path.join(rroot, "uptime"))
    shutil.copytree(os.path.join(stbl.flags.dir, "uptime"),
                    os.path.join(sroot, "uptime"))
    n0 = len(up["host"])
    pmax = int(up["ping"].max())
    ntail = RS_LOGS * RS_LOG_ROWS
    lines, tail = rowstore_tail(n0, ntail, pmax)
    upath = os.path.join(root, "rs_tail.json")
    with open(upath, "w") as f:
        f.write("\n".join(lines) + "\n")
    slines, stail = sets_tail(len(sarr["host"]), RS_SETS_ROWS)
    spath = os.path.join(root, "rs_sets_tail.json")
    with open(spath, "w") as f:
        f.write("\n".join(slines) + "\n")
    del lines, slines
    say(f"row store: copies of the uptime and sets tables and the tails' "
        f"JSON lines ({ntail} and {RS_SETS_ROWS} records) in "
        f"{time.perf_counter() - t0:.1f}s")
    for d, path, n, nlogs in ((rroot, upath, ntail, RS_LOGS),
                              (sroot, spath, RS_SETS_ROWS, 1)):
        rc, _, wall, _ = run_cli(["ingest", "-dir", d, "-table", "uptime",
                                  "-skip-compact", "-infile", path])
        logs = rowstore.list_logs(os.path.join(d, "uptime"))
        if rc != 0 or len(logs) != nlogs:
            fail(f"row store: ingest into {d} exited {rc} with {len(logs)} "
                 f"logs, expected {nlogs}")
        say(f"[{card}] row store: `ingest -skip-compact` of {n} records "
            f"into {nlogs} log(s) in {wall:.3f}s ({n / wall:.0f} "
            f"records/s, host CPU)")
    rtab = Table("uptime", Flags(dir=rroot, table="uptime"))
    stab = Table("uptime", Flags(dir=sroot, table="uptime"))
    rtab.load_info()
    stab.load_info()
    B = len(rtab.block_infos())

    # numpy over the digested rows and the tail
    allv = {k: np.concatenate([up[k], tail[k]])
            for k in ("host", "status", "ping", "weight", "time")}
    allv["index_int"] = np.concatenate([np.arange(n0, dtype=np.int64),
                                        tail["index_int"]])
    f1, p1 = cli_query(rtab, RS_C1, dev_arg)
    agg1 = bound_query(rtab, f1, p1).config.aggs[0]
    if not (pmax + 40 <= agg1.discard_max):
        fail(f"row store: the tail's pings up to {pmax + 40} leave the "
             f"discard window {agg1.discard_max}")

    def groupby(keys, vals):
        uk, inv = np.unique(np.stack(keys, 1), axis=0, return_inverse=True)
        cnt = np.bincount(inv.reshape(-1))
        tot = np.zeros(len(uk), np.int64)
        np.add.at(tot, inv.reshape(-1), vals)
        return {tuple(k): (int(c), int(s_)) for k, c, s_ in
                zip(uk.tolist(), cnt.tolist(), tot.tolist())}

    want1 = {(RS_HOSTS[h],): v for (h,), v in
             groupby([allv["host"]], allv["ping"]).items()}

    def check_avg(label, rows, want, keys):
        got = {tuple(str(r[k]) for k in keys): (r["Count"], r["Samples"],
                                                r["ping"]) for r in rows}
        exp = {tuple(str(x) for x in k): (c, c, s_ / c)
               for k, (c, s_) in want.items()}
        if got != exp:
            bad = sorted(k for k in set(got) | set(exp)
                         if got.get(k) != exp.get(k))[:5]
            fail(f"row store {label}: rows differ from numpy at {bad}: "
                 f"{[(got.get(k), exp.get(k)) for k in bad]}")
        return len(exp)

    ok200 = allv["status"] == STATII.index("200")

    def check(label, out):
        rows = json.loads(out)
        if label.startswith("config 1 -data") or label == "config 1":
            return f"{check_avg(label, rows, want1, ('host',))} groups"
        if label == "config 3 -loghist":
            f, p = cli_query(rtab, RS_ARGV[label], dev_arg)
            agg = bound_query(rtab, f, p).config.aggs[0]
            wanth = numpy_hist(allv["host"], len(RS_HOSTS), ok200,
                               allv["ping"], agg)
            ng, nout = check_hist_json(label, rows, agg, wanth,
                                       lambda g: (RS_HOSTS[g],), ("host",))
            return f"{ng} groups, {nout} outliers"
        if label == "1 h rollup":
            q = allv["time"] // C4_BUCKET * C4_BUCKET     # times > 0
            want = groupby([q, allv["host"]], allv["ping"])
            got = {(int(tb_), r["host"]): (r["Count"], r["ping"])
                   for tb_, rs_ in rows.items() for r in rs_}
            exp = {(tb_, RS_HOSTS[h]): (c, s_ / c)
                   for (tb_, h), (c, s_) in want.items()}
            if got != exp:
                fail(f"row store {label}: rows differ from numpy")
            return f"{len(exp)} (bucket, host) rows"
        if label == "path 1 (-tdigest)":
            f, p = cli_query(rtab, RS_ARGV[label], dev_arg)
            agg = bound_query(rtab, f, p).config.aggs[0]
            keep = ok200 & (allv["ping"] >= agg.discard_min) & \
                (allv["ping"] <= agg.discard_max)
            for r in rows:
                h = RS_HOSTS.index(r["host"])
                if r["Count"] != int((ok200 & (allv["host"] == h)).sum()) \
                        or r["ping"]["samples"] != int(
                            (keep & (allv["host"] == h)).sum()):
                    fail(f"row store {label}: host {r['host']} differs "
                         f"from numpy")
            if len(rows) != len(np.unique(allv["host"][ok200])):
                fail(f"row store {label}: {len(rows)} hosts")
            return f"{len(rows)} hosts' counts and kept rows"
        if label == "distinct index_int":
            hlls = numpy_hlls(allv["host"], len(RS_HOSTS),
                              allv["index_int"], "int")
            for r in rows:
                if r["Distinct"] != hlls[RS_HOSTS.index(
                        r["host"])].cardinality():
                    fail(f"row store {label}: {r} vs numpy")
            return f"{len(rows)} groups' Distinct"
        if label == "config 1 by host and weight":
            want = {(RS_HOSTS[h], w): v for (h, w), v in
                    groupby([allv["host"], allv["weight"]],
                            allv["ping"]).items()}
            ng = check_avg(label, rows, want, ("host", "weight"))
            return f"{ng} groups"
        raise AssertionError(label)

    # counters of the rowstore phase, each log's decode, and K3's keyed
    # form checked against its plain version on every pseudo-block
    rs = {k: 0 for k in COUNTED}
    decoded = {"native": 0, "fallback": 0}
    devs = set()
    state = {"label": None}
    captured = {}
    real_rs, real_pl = engine._scan_rowstore, columnar.parse_log_columnar
    real_k3 = scan.dense_pack

    def counted_rs(acc, ctx, table_):
        before = kernels.snapshot()
        real_rs(acc, ctx, table_)
        for k in COUNTED:
            rs[k] += kernels.LAUNCHES[k] - before[k]
        devs.add(ctx.device.type)

    def counted_pl(path, table_):
        batch = real_pl(path, table_)
        decoded["native" if batch is not None else "fallback"] += 1
        return batch

    def checked_k3(config, k2, hists, nouts, main, R, hll=None,
                   time_bucket=1):
        real_k3(config, k2, hists, nouts, main, R, hll, time_bucket)
        if state["label"] is None or "keys" in k2 or \
                not config.no_compact_table:
            return
        want = main.clone()
        scan.dense_pack_plain(config, k2, hists, nouts, want, R, hll,
                              time_bucket)
        check_equal(f"K3 keyed {state['label']} pseudo-block (slots "
                    f"{config.dense_slots}, Sc {scan.reduce_space(config)[1]})",
                    main, want, errs["dense_keyed"])
        captured.setdefault(state["label"], (config, k2, hists, nouts, main,
                                             R, hll, time_bucket))

    engine._scan_rowstore = counted_rs
    columnar.parse_log_columnar = counted_pl
    scan.dense_pack = checked_k3
    engine.ROWSTORE["sorted_retries"] = 0
    answers = {}
    try:
        queries = [(label, rroot, argv, RS_LOGS)
                   for label, argv in RS_ARGV.items()]
        queries.append(("S1", sroot, S_ARGV["S1"], 1))
        residency.CACHE.clear()
        for label, d, argv, nlogs in queries:
            state["label"] = label
            decoded.update(native=0, fallback=0)
            retries = engine.ROWSTORE["sorted_retries"]
            before = dict(rs)
            rc, out, wall, ll = run_cli(
                ["query", "-dir", d, "-table", "uptime", *argv, "-read-log",
                 "-json", "-device-batch", str(B), "-device", dev_arg])
            if rc != 0:
                fail(f"row store {label}: port CLI query exited {rc}")
            if decoded != {"native": nlogs, "fallback": 0}:
                fail(f"row store {label}: logs decoded {decoded}, expected "
                     f"{nlogs} natively")
            if label == "S1":
                sel_d = sarr["index_int"] % 3 == 0
                sel_t = stail["index_int"] % 3 == 0
                want_s = {(HOSTS[h],): v for (h,), v in groupby(
                    [np.concatenate([sarr["host"][sel_d],
                                     stail["host"][sel_t]])],
                    np.concatenate([sarr["ping"][sel_d],
                                    stail["ping"][sel_t]])).items()}
                ng = check_avg(label, json.loads(out), want_s, ("host",))
                what = f"{ng} groups"
            else:
                what = check(label, out)
            phase = {k: rs[k] - before[k] for k in COUNTED
                     if rs[k] != before[k]}
            took = engine.ROWSTORE["sorted_retries"] - retries
            if label == "config 1 by host and weight" and took < 1:
                fail(f"row store {label}: no pseudo-block took the sorted "
                     f"retry")
            answers[label] = out
            say(f"main path: CLI {label} -read-log on {dev_arg} == numpy "
                f"over the blocks and the tail ({what}); {nlogs} log(s) "
                f"decoded natively; rowstore phase launches {phase}; sorted "
                f"retries {took}; wall {wall:.3f}s")
            tally(launches, ll)
        state["label"] = None
        if devs != {dev_arg}:
            fail(f"row store: the rowstore phase ran on {devs}")
        for k in ("dense_scan", "dense_keyed"):
            if rs[k] == 0:
                fail(f"row store: the rowstore phase never launched {k}")
        say(f"row store: the rowstore phase over every query launched "
            f"{ {k: v for k, v in rs.items() if v} }; "
            f"{engine.ROWSTORE['sorted_retries']} sorted retries")

        # walls with the rowstore phase: config 1 through run_query
        fq, pq = cli_query(rtab, RS_C1 + ["-read-log", "-device-batch",
                                          str(B)], dev_arg)
        walls = {"cold": [], "warm": []}
        for kind in ("cold", "warm"):
            for _ in range(3):
                if kind == "cold":
                    residency.CACHE.clear()
                if device.type == "cuda":
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                run_query(Table("uptime", fq), pq, fq)
                walls[kind].append(time.perf_counter() - t1)
        for kind, ws in walls.items():
            say(f"[{card}] config 1 -read-log ({n0} digested rows, {ntail} "
                f"in {RS_LOGS} logs) {kind} query wall median of 3: "
                f"{median(ws) * 1e3:.3f} ms "
                f"({(n0 + ntail) / median(ws):.0f} rows/s); walls "
                f"{[round(x * 1e3, 3) for x in ws]}")
        phase_lines(card, "config 1 -read-log",
                    lambda: run_query(Table("uptime", fq), pq, fq),
                    residency.CACHE.clear)
    finally:
        engine._scan_rowstore, columnar.parse_log_columnar = real_rs, real_pl
        scan.dense_pack = real_k3

    edge = keyed_edge_checks(device, errs)
    say(f"K3 keyed form == plain (tolerance 0) on every -read-log "
        f"pseudo-block above and {len(edge)} synthetic configs: "
        + "; ".join(edge))

    # K3's keyed form at config 1's and config 3 -loghist's pseudo-block
    rows = []
    for label in ("config 1", "config 3 -loghist"):
        config, k2, hists, nouts, main, R, hll, tb = captured[label]
        ms = cuda_ms(lambda: scan.dense_pack(config, k2, hists, nouts, main,
                                             R, hll, tb), iters=200)
        dms = queued_ms(lambda: scan.dense_pack(config, k2, hists, nouts,
                                                main, R, hll, tb))
        pms = cuda_ms(lambda: scan.dense_pack_plain(
            config, k2, hists, nouts, main, R, hll, tb), iters=20)
        slots, Sc, _ = scan.reduce_space(config)
        H = len(hists)
        lo, hi = scan.outlier_rows(config, R)
        lay = scan.packed_layout(config, R)
        # the compact sums, min/max and bucket rows read once; every word
        # of `main` outside K5's rows written once (the keyed table is
        # slots x (K + 2 + 5A) of them)
        nbytes = (k2["sums"].numel() + 2 * Sc * H
                  + sum(h.numel() for h in hists)
                  + (lay["rows"] - (hi - lo)) * lay["W"]) * 8
        what = (f"{label} -read-log pseudo-block ({R} rows, slots {slots}, "
                f"Sc {Sc}, {config.n_key_cols + 2 + 5 * len(config.aggs)} "
                f"words a slot)")
        say(f"[{card}] dense_keyed {what}: {ms:.4f} ms by events, "
            f"{dms:.4f} ms device (queued behind a sleep kernel); plain "
            f"{pms:.4f} ms; bound {nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms "
            f"by bytes ({nbytes} B); {rs['dense_keyed']} launches in the "
            f"rowstore phases of this section's queries and walls")
        rows.append(("dense_keyed", what, "sybil_tpu/ops/scan.py:1865", ms,
                     pms, nbytes, 0, None))

    # digest both tails in a process of its own, then the same queries
    # without -read-log
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    for d, n, nb_want in ((rroot, ntail, B + ntail // RS_LOG_ROWS),
                          (sroot, RS_SETS_ROWS, None)):
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sybil_tpu_torch", "digest", "-dir", d,
             "-table", "uptime"], cwd=here, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t1
        if proc.returncode != 0:
            fail(f"row store: digest of {d} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        tab = Table("uptime", Flags(dir=d, table="uptime"))
        tab.load_info()
        nb = len(tab.block_infos())
        if rowstore.list_logs(tab.dir) or (nb_want and nb != nb_want):
            fail(f"row store: after the digest {d} has "
                 f"{len(rowstore.list_logs(tab.dir))} logs, {nb} blocks")
        say(f"[{card}] `python -m sybil_tpu_torch digest`: {n} records in "
            f"{wall:.3f}s ({n / wall:.0f} rows/s, the process's start "
            f"included, host CPU), {nb} blocks")
    residency.CACHE.clear()
    for label, d, argv, _ in queries:
        nb = len(Table("uptime", Flags(dir=d, table="uptime"))
                 .block_infos())
        rc, out, wall, ll = run_cli(
            ["query", "-dir", d, "-table", "uptime", *argv, "-json",
             "-device-batch", str(nb), "-device", dev_arg])
        if rc != 0:
            fail(f"row store {label} after the digest: exited {rc}")
        pre, post = json.loads(answers[label]), json.loads(out)
        if label.startswith("path 1"):
            # a t-digest's percentiles depend on the batching: its counts
            # and kept rows are exact
            pre = sorted((r["host"], r["Count"], r["ping"]["samples"])
                         for r in pre)
            post = sorted((r["host"], r["Count"], r["ping"]["samples"])
                          for r in post)
            same = pre == post
        else:
            same = json_rows(answers[label]) == json_rows(out)
        if not same:
            fail(f"row store {label}: the digested table's answer differs "
                 f"from the -read-log answer before the digest")
        say(f"row store: {label} without -read-log after the digest == its "
            f"-read-log answer before ({nb} blocks); wall {wall:.3f}s")
    return rows


# ---------------------------------------------------------------------------
# the host tools: index, rebuild, -update-info, trim, -export, inspect, API
# ---------------------------------------------------------------------------

TOOLS_BLOCKS = 16               # the trim and export copy: 1,048,576 rows
TOOLS_WAL_ROWS = 65536          # the log that `inspect` reads


def tools_phase(card, root, table, up, device):
    """The port's host tools on copies of the uptime table, every query on
    `device` through the CLI (in process, or in a fresh `python -m
    sybil_tpu_torch`) or the client API, each answer against numpy over
    the arrays that built the table.  On a full copy: config 1, `index`
    (the table's int min/max of ping and time == numpy's, config 1's
    bytes unchanged), `rebuild` of a deleted info.json (config 1 == numpy
    in this process and in a fresh one), the API's group-by in process
    and in a subprocess.  On a copy of the first TOOLS_BLOCKS blocks:
    `query -update-info`, `trim -mb` (the blocks numpy's ranking names),
    calculate_icc of a hist group-by on `device` and on the CPU, `trim
    -before -delete -really` and config 1 over the rest, `query -export`
    (every TSV == numpy's).  `inspect` of the table info, a block info, a
    column, a dictionary and a WAL log of TOOLS_WAL_ROWS records."""
    import gzip

    import numpy as np

    from sybil_tpu_torch import api, blocks, rowstore
    from sybil_tpu_torch.config import Flags
    from sybil_tpu_torch.ops import kernels
    from sybil_tpu_torch.query.engine import run_query
    from sybil_tpu_torch.query.stats import calculate_icc
    from sybil_tpu_torch.table import Table

    dev_arg = device.type
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t_phase = time.perf_counter()
    walls = []

    def step(short, label, t1):
        walls.append((short, time.perf_counter() - t1))
        say(f"[{card}] tools: {label}: wall {walls[-1][1]:.3f}s")

    def cli(label, argv):
        rc, out, _, ll = run_cli(argv)
        if rc != 0:
            fail(f"tools {label}: `{' '.join(argv[:1])}` exited {rc}")
        return out, ll

    def query(label, d, argv=RS_C1):
        out, ll = cli(label, ["query", "-dir", d, "-table", "uptime", *argv,
                              "-json", "-device-batch", "1024", "-device",
                              dev_arg])
        ran = {k: v for k, v in ll.items() if v}
        if dev_arg == "cuda" and not (ll["dense_scan"] and
                                      ll["dense_pack"]):
            fail(f"tools {label}: the query launched {ran}")
        return out, ran

    def check_c1(label, rows, sel):
        want = numpy_groupby(up["host"][sel], up["ping"][sel])
        got = {r["host"]: (r["Count"], r["Samples"], r["ping"])
               for r in rows}
        exp = {h: (c, c, s_ / c) for h, (c, s_) in want.items() if c}
        if got != exp:
            bad = sorted(h for h in set(got) | set(exp)
                         if got.get(h) != exp.get(h))
            fail(f"tools {label}: rows differ from numpy at {bad}: "
                 f"{[(got.get(h), exp.get(h)) for h in bad]}")
        return sum(c for c, _, _ in exp.values())

    def block_rows(tab, bdir):
        """The table rows a block holds, in its order (its index_int)."""
        cd = blocks.load_block_columns(bdir, tab.schema, ["index_int"])
        return cd["index_int"].values[:blocks.load_block_info(
            bdir).num_records]

    def int_bounds(label, tab, sel):
        tab.load_info()
        for col in ("ping", "time"):
            ii = tab.schema.int_info[tab.schema.key_table[col]]
            want = (int(up[col][sel].min()), int(up[col][sel].max()))
            if (ii.min, ii.max) != want:
                fail(f"tools {label}: the table's {col} min/max "
                     f"{(ii.min, ii.max)}, numpy {want}")

    n0 = len(up["host"])
    every = np.ones(n0, bool)

    # ---- a full copy: index, rebuild ---------------------------------
    t1 = time.perf_counter()
    froot = os.path.join(root, "tools_full")
    shutil.copytree(table.dir, os.path.join(froot, "uptime"))
    ftab = Table("uptime", Flags(dir=froot, table="uptime"))
    nb = len(ftab.list_block_dirs())
    step("full copy", f"copy of the uptime table ({nb} blocks)", t1)
    t1 = time.perf_counter()
    c1, ran = query("config 1", froot)
    n = check_c1("config 1", json.loads(c1), every)
    step("config 1",
         f"config 1 on {dev_arg} == numpy ({n} rows; launches {ran})", t1)

    t1 = time.perf_counter()
    cli("index", ["index", "-dir", froot, "-table", "uptime"])
    int_bounds("index", ftab, every)
    out, ran = query("config 1 after index", froot)
    if out != c1:
        fail("tools: config 1 after `index` prints other bytes")
    step("index",
         f"`index`: ping and time min/max == numpy's; config 1 prints the "
         f"same bytes (launches {ran})", t1)

    t1 = time.perf_counter()
    kt_before = dict(ftab.schema.key_table)
    for f in ("info.json", "info.json.bak"):
        if os.path.exists(os.path.join(ftab.dir, f)):
            os.unlink(os.path.join(ftab.dir, f))
    cli("rebuild", ["rebuild", "-dir", froot, "-table", "uptime"])
    ftab.load_info()
    if set(ftab.schema.key_table) != set(kt_before):
        fail(f"tools: rebuild's columns {ftab.schema.key_table}, before "
             f"{kt_before}")
    out, ran = query("config 1 after rebuild", froot)
    check_c1("config 1 after rebuild", json.loads(out), every)
    step("rebuild",
         f"`rebuild` of a deleted info.json (key ids {kt_before} -> "
         f"{ftab.schema.key_table}); config 1 in this process == numpy "
         f"(launches {ran})", t1)

    # config 1 in a fresh process (seconds to reach the card) runs beside
    # the steps below; read at the phase's end
    cfg = api.SybilConfig(dir=froot, table="uptime", device=dev_arg)
    t_fresh = time.perf_counter()
    fresh_proc = subprocess.Popen(
        [sys.executable, "-m", "sybil_tpu_torch", "query", "-dir", froot,
         "-table", "uptime", *RS_C1, "-json", "-device-batch", "1024",
         "-device", dev_arg], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # ---- the client API over the full copy, in process and as a
        # subprocess (its `python -m sybil_tpu_torch` found from the cwd)
        t1 = time.perf_counter()
        kernels.reset_launches()
        rows = api.SybilTable(cfg).query().group_by("host").aggregate(
            "ping").execute()
        ll = kernels.snapshot()
        check_c1("API in process", rows, every)
        if dev_arg == "cuda" and not ll["dense_scan"]:
            fail(f"tools: the API's query launched {dict(ll)}")
        step("API",
             f"API group_by(host).aggregate(ping) in process on {dev_arg} "
             f"== numpy (dense_scan launches {ll['dense_scan']})", t1)

        t1 = time.perf_counter()
        with contextlib.chdir(here):
            rows = api.SybilTable(cfg, subprocess_mode=True).query(
            ).group_by("host").aggregate("ping").execute()
        check_c1("API subprocess", rows, every)
        step("API subprocess", f"API group_by(host).aggregate(ping) with "
             f"subprocess_mode on {dev_arg} == numpy", t1)

        # ---- a 16-block copy: -update-info, trim, ICC, -export --------
        t1 = time.perf_counter()
        sroot = os.path.join(root, "tools_16")
        sdir = os.path.join(sroot, "uptime")
        os.makedirs(sdir)
        for name in ("dicts", "info.json"):
            src = os.path.join(table.dir, name)
            (shutil.copytree if os.path.isdir(src) else shutil.copy2)(
                src, os.path.join(sdir, name))
        for bdir in sorted(table.block_infos())[:TOOLS_BLOCKS]:
            shutil.copytree(bdir, os.path.join(sdir, os.path.basename(bdir)))
        stab = Table("uptime", Flags(dir=sroot, table="uptime"))
        stab.load_info()
        sdirs = stab.list_block_dirs()
        rows_of = {d: block_rows(stab, d) for d in sdirs}
        sel16 = np.zeros(n0, bool)
        sel16[np.concatenate(list(rows_of.values()))] = True
        step("16-block copy",
             f"copy of {len(sdirs)} blocks ({int(sel16.sum())} rows)", t1)

        t1 = time.perf_counter()
        cli("-update-info", ["query", "-dir", sroot, "-table", "uptime",
                             "-update-info", "-device", dev_arg])
        int_bounds("-update-info", stab, sel16)
        step("-update-info",
             "`query -update-info`: ping and time min/max == numpy's over the "
             "copy", t1)

        t1 = time.perf_counter()
        infos = stab.block_infos()
        tmax = {d: int(up["time"][r].max()) for d, r in rows_of.items()}
        # newest first; blocks that share their newest time keep their order
        # by name, as trim's stable sort of the block listing does
        ranked = sorted(sdirs, key=lambda d: tmax[d], reverse=True)
        total = sum(infos[d].size for d in sdirs)
        mb = max(1, total // 2 // (1 << 20))
        cum, want = 0, []
        for d in ranked:
            cum += infos[d].size
            if cum > mb << 20:
                want.append(d)
        out, _ = cli("trim -mb", ["trim", "-dir", sroot, "-table", "uptime",
                                  "-mb", str(mb)])
        if out.splitlines() != want or not 0 < len(want) < len(sdirs):
            fail(f"tools: trim -mb {mb} listed {len(out.splitlines())} "
                 f"blocks, numpy's ranking {len(want)}")
        step("trim -mb",
             f"`trim -mb {mb}` ({total} bytes in {len(sdirs)} blocks) lists "
             f"the {len(want)} blocks past the budget, oldest last, as numpy "
             f"ranks them", t1)

        t1 = time.perf_counter()
        # the time column's hist by weight: group means that differ (by about
        # a thousand seconds), so the ICC is not 0
        icc_argv = ["-group", "weight", "-int", "time", "-op", "hist"]
        fh, ph = cli_query(stab, icc_argv, dev_arg)
        fc, pc = cli_query(stab, icc_argv, "cpu")
        qr_dev = run_query(Table("uptime", fh), ph, fh)
        qr_cpu = run_query(Table("uptime", fc), pc, fc)
        if snapshot(qr_dev) != snapshot(qr_cpu):
            fail(f"tools: -op hist by weight on {dev_arg} differs from the "
                 f"CPU")
        icc = calculate_icc(qr_dev, ph)["time"]
        icc_cpu = calculate_icc(qr_cpu, pc)["time"]
        if not (np.isfinite(icc) and 0 < icc_cpu
                and abs(icc - icc_cpu) <= 1e-12 * abs(icc_cpu)):
            fail(f"tools: calculate_icc on {dev_arg} {icc!r}, on the CPU "
                 f"{icc_cpu!r}")
        step("ICC", f"calculate_icc of -op hist of time by weight on "
             f"{dev_arg} {icc!r} == on the CPU {icc_cpu!r} (1e-12 relative; "
             f"the hists equal)", t1)

        t1 = time.perf_counter()
        cut = tmax[ranked[len(ranked) // 2 - 1]]
        gone = sorted(d for d in sdirs if tmax[d] < cut)
        out, _ = cli("trim -delete", ["trim", "-dir", sroot, "-table",
                                      "uptime", "-before", str(cut),
                                      "-delete", "-really"])
        left = stab.list_block_dirs()
        if sorted(ln.split(" ", 1)[1] for ln in out.splitlines()) != gone or \
                sorted(set(sdirs) - set(left)) != gone:
            fail(f"tools: trim -before {cut} -delete -really left {len(left)} "
                 f"blocks, numpy {len(sdirs) - len(gone)}")
        keep = np.zeros(n0, bool)
        keep[np.concatenate([rows_of[d] for d in left])] = True
        out, ran = query("config 1 after trim", sroot)
        n = check_c1("config 1 after trim", json.loads(out), keep)
        step("trim -delete",
             f"`trim -before {cut} -delete -really` deleted the {len(gone)} "
             f"blocks numpy names; config 1 over the {len(left)} left == "
             f"numpy ({n} rows; launches {ran})", t1)

        t1 = time.perf_counter()
        out, ran = query("-export", sroot, ["-export", "-group", "host",
                                             "-int", "ping"])
        if not out.startswith("EXPORTED RECORDS TO "):
            fail(f"tools: -export printed {out[:200]!r}")
        check_c1("-export's query", json.loads(out.split("\n", 1)[1]), keep)
        ints = ["index_int", "ping", "time", "weight"]
        header = "\t".join(ints + ["host", "status"])
        for d in left:
            r = rows_of[d]
            cols = [up[c][r].tolist() if c != "index_int" else r.tolist()
                    for c in ints]
            cols.append([HOSTS[i] for i in up["host"][r].tolist()])
            cols.append([STATII[i] for i in up["status"][r].tolist()])
            want = header + "\n" + "\n".join(
                "\t".join(map(str, row)) for row in zip(*cols))
            path = os.path.join(sdir, "export",
                                os.path.basename(d) + ".tsv.gz")
            with gzip.open(path, "rt") as f:
                if f.read() != want:
                    fail(f"tools: {path} differs from numpy's TSV")
        step("-export",
             f"`query -export -group host -int ping`: {len(left)} TSVs == "
             f"numpy's, the query == numpy (launches {ran})", t1)

        # ---- inspect --------------------------------------------------
        t1 = time.perf_counter()
        wroot = os.path.join(root, "tools_wal")
        lines, _ = rowstore_tail(n0, TOOLS_WAL_ROWS, int(up["ping"].max()))
        wpath = os.path.join(root, "tools_wal.json")
        with open(wpath, "w") as f:
            f.write("\n".join(lines) + "\n")
        cli("ingest", ["ingest", "-dir", wroot, "-table", "uptime",
                       "-skip-compact", "-infile", wpath])
        logs = rowstore.list_logs(os.path.join(wroot, "uptime"))
        if len(logs) != 1:
            fail(f"tools: the ingest wrote {len(logs)} logs")
        b0 = ftab.list_block_dirs()[0]
        targets = [
            (os.path.join(ftab.dir, "info.json"), "# info.json: json"),
            (os.path.join(b0, "info.json"), "# info.json: json"),
            (os.path.join(b0, "int_ping.sy"),
             "# int_ping.sy: container meta="),
            (os.path.join(ftab.dir, "dicts", "host.sy"),
             "# host.sy: container meta="),
            (logs[0], f"# {os.path.basename(logs[0])}: row-store log, "
                      f"{TOOLS_WAL_ROWS} records")]
        for path, head in targets:
            out, _ = cli("inspect", ["inspect", path])
            first = out.split("\n", 1)[0]
            if not (first == head or (head.endswith("=") and
                                      first.startswith(head))):
                fail(f"tools: inspect {path} printed {first!r}")
        step("inspect", f"`inspect` of the table info, a block info, "
             f"int_ping.sy, dicts/host.sy and a log of {TOOLS_WAL_ROWS} "
             f"records: each header as expected", t1)

        out, err = fresh_proc.communicate(timeout=600)
    finally:
        if fresh_proc.poll() is None:
            fresh_proc.kill()
            fresh_proc.wait()
    if fresh_proc.returncode != 0:
        fail(f"tools: the fresh `python -m sybil_tpu_torch query` exited "
             f"{fresh_proc.returncode}: {err[-2000:]}")
    check_c1("fresh query", json.loads(out), every)
    walls.append(("fresh query", time.perf_counter() - t_fresh))
    say(f"[{card}] tools: config 1 after rebuild in a fresh `python -m "
        f"sybil_tpu_torch query` == numpy: started {walls[-1][1]:.3f}s "
        f"before the phase's end read it, beside the steps after `rebuild`")

    total_s = time.perf_counter() - t_phase
    say(f"[{card}] tools phase: {total_s:.1f}s in all; walls "
        + "; ".join(f"{short} {w:.3f}s" for short, w in walls))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=DEFAULT_ROWS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from sybil_tpu_torch.ops import kernels, residency, scan
    from sybil_tpu_torch.ops.decode import (decode_bucket2, decode_bucket2_plain,
                                            decode_value, decode_value_plain)
    from sybil_tpu_torch.ops.residency import device_const
    from sybil_tpu_torch.query.engine import run_query

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = smi
    say(smi)
    t0 = time.perf_counter()
    kernels.build()
    say(f"[{card}] built {len(kernels.SOURCES)} kernels with nvcc in "
        f"{time.perf_counter() - t0:.3f}s")
    if tuple(sorted(kernels.SOURCES)) != tuple(sorted(KERNELS)):
        fail(f"kernel sources {kernels.SOURCES} are not {KERNELS}")
    if kernels.ENTRY_SOURCES != ENTRY_SOURCES:
        fail(f"counted entries {kernels.ENTRY_SOURCES} are not "
             f"{ENTRY_SOURCES}")
    for name in kernels.SOURCES:
        with open(os.path.join(kernels.BUILD_DIR, name + ".log")) as f:
            fn = ""
            for line in f:
                if "Function properties for" in line:
                    # the entry point (mangled: its template arguments
                    # show as ILb0ELb1E...)
                    fn = line.rsplit(" ", 1)[-1].strip()
                elif "registers" in line or "spill" in line:
                    say(f"  ptxas {name} {fn}: {line.strip()}")

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    sets_proc = None
    try:
        # ---- phase 2 ---------------------------------------------------
        sets_root = os.path.join(root, "sets")
        sets_proc = start_sets_table(sets_root, args.rows)
        t0 = time.perf_counter()
        table, flags, up = build_table(os.path.join(root, "up"), args.rows)
        nblocks = len(table.block_infos())
        say(f"built uptime table: {args.rows} rows, {nblocks} blocks in "
            f"{time.perf_counter() - t0:.1f}s (host CPU)")
        t0 = time.perf_counter()
        stable, sflags, ttable, tflags, us, actions, pages = build_sessions(
            os.path.join(root, "us"), os.path.join(root, "us_sorted"),
            args.rows)
        say(f"built user_sessions tables (bulk and time-sorted): "
            f"{args.rows} rows, {len(stable.block_infos())} and "
            f"{len(ttable.block_infos())} blocks in "
            f"{time.perf_counter() - t0:.1f}s (host CPU)")
        tables4 = {"bulk": (stable, sflags), "time-sorted": (ttable, tflags)}
        t0 = time.perf_counter()
        parts = build_zipf_partitions(os.path.join(root, "c5"), args.rows)
        from sybil_tpu_torch.query import engine as port_engine
        params5 = query_params(["userid"], ["weight"])   # -limit 100, $COUNT
        c5, c5_time = [], []
        for pi_, (t5, f5, uid5, w5, tm5) in enumerate(parts):
            c5_time.append(tm5)
            dirs5 = [d for d in t5.block_infos()]
            b5q = bound_query(t5, f5, params5)
            port_engine._maybe_device_prune(b5q, params5, dirs5, C5_BATCH)
            cfg5 = b5q.config
            nb5 = -(-len(dirs5) // C5_BATCH)
            c5.append((t5, f5, uid5, w5, dirs5, cfg5, nb5))
            say(f"built config 5 partition {pi_ + 1}: {len(uid5)} rows, "
                f"{len(dirs5)} blocks of up to "
                f"{max(b.num_records for b in t5.block_infos().values())} "
                f"rows, {nb5} batch(es) at device_batch {C5_BATCH}; userid "
                f"cardinality {len(t5.dicts.get('userid').strings)} "
                f"({len(np.unique(uid5))} users drawn); prune_topk "
                f"{cfg5.prune_topk}, enum_radix {scan.enum_radix(cfg5)}, "
                f"strategy {cfg5.strategy}, lane_row_bounds "
                f"{cfg5.lane_row_bounds}")
            if scan.enum_radix(cfg5) <= 0:
                fail(f"config 5 partition {pi_ + 1} is not enumerable")
        say(f"built config 5's two partitions in "
            f"{time.perf_counter() - t0:.1f}s (host CPU)")
        t0 = time.perf_counter()
        stbl, stflags, sarr = join_sets_table(sets_proc, sets_root)
        say(f"the sets table (uptime with groups): {args.rows} rows, "
            f"{len(stbl.block_infos())} blocks; waited "
            f"{time.perf_counter() - t0:.1f}s for its process")
        C = 65536 if args.rows > 8192 else 128
        while C < min(args.rows, 65536):
            C *= 2
        errs = {k: [] for k in COUNTED}

        # ---- phase 3: K1 -------------------------------------------------
        from sybil_tpu_torch import blocks
        dirs = sorted(table.block_infos())
        k1_main = {}
        for name in ("host", "ping"):
            typ = table.schema.col_type(name)
            cs = [blocks.open_column(d, typ, name) for d in dirs]
            ins, got = k1_check(f"table {name}", cs, C, dev,
                                errs["decode_bucket2"])
            k1_main[name] = (ins, cs)
            # and against the host decoder of the block store
            for bi in (0, len(cs) - 1):
                host = (blocks.decode_int_container(cs[bi])
                        if name == "ping" else
                        blocks.decode_str_container(cs[bi]))
                hv = host.values if name == "ping" else host.ids
                n = len(hv)
                if not (np.array_equal(got[0][bi, :n].cpu().numpy(), hv)
                        and np.array_equal(got[1][bi, :n].cpu().numpy(),
                                           host.valid)):
                    fail(f"K1 table {name} block {bi} differs from the "
                         f"host decoder")
        edges = edge_containers()
        for label, cs, cc in edges:
            k1_check(label, cs, cc, dev, errs["decode_bucket2"])
        say(f"K1 decode_bucket2 == plain (tolerance 0) on the table's host "
            f"and ping columns and {len(edges)} edge batches: "
            + ", ".join(label for label, _, _ in edges))
        k1_edge_checks(card, dev, errs)

        # K6 on the real time containers of both user_sessions tables
        k6_main = {}
        for tlabel, (t4, _) in tables4.items():
            tdirs = sorted(t4.block_infos())
            typ = t4.schema.col_type("time")
            cs = [blocks.open_column(d, typ, "time") for d in tdirs]
            encs = {c.meta["encoding"] for c in cs}
            dts = {str(c.read("deltas").dtype) for c in cs
                   if c.meta["encoding"] == "value"}
            if encs != {"value"}:
                fail(f"{tlabel} table: time is {encs}-encoded, not value")
            ins = k6_inputs(cs, C, dev)
            got = decode_value(*ins, C)
            want = decode_value_plain(*ins, C)
            check_equal(f"K6 {tlabel} time values", got[0], want[0],
                        errs["decode_value"])
            check_equal(f"K6 {tlabel} time valid", got[1], want[1],
                        errs["decode_value"])
            for bi in (0, len(cs) - 1):
                host = blocks.decode_int_container(cs[bi])
                n = len(host.values)
                if not (np.array_equal(got[0][bi, :n].cpu().numpy(),
                                       host.values)
                        and np.array_equal(got[1][bi, :n].cpu().numpy(),
                                           host.valid)):
                    fail(f"K6 {tlabel} time block {bi} differs from the "
                         f"host decoder")
            k6_main[tlabel] = ins
            say(f"K6 decode_value == plain (tolerance 0) on the {tlabel} "
                f"table's time column ({len(cs)} value blocks, deltas "
                f"{sorted(dts)})")
        b5 = b5_edge_containers()
        for label, cs, cc in b5:
            kinds = decode_check(label, cs, cc, dev, errs)
            say(f"  decode edge batch {label}: kinds {kinds} == plain")
        say(f"K6 decode_value and K1's v1 mode == plain (tolerance 0) on "
            f"{len(b5)} edge batches, mixed kinds included")
        # K6's id mode on the sets table's index_str, a distinct string a
        # row: the str-value containers a column past
        # CARDINALITY_THRESHOLD distinct values a block writes
        sdirs = sorted(stbl.block_infos())
        styp = stbl.schema.col_type("index_str")
        ids_main = [blocks.open_column(d, styp, "index_str") for d in sdirs]
        encs = {c.meta["encoding"] for c in ids_main}
        if encs != {"value"}:
            fail(f"sets table: index_str is {encs}-encoded, not value")
        if decode_check("sets table index_str", ids_main, C, dev,
                        errs) != ["str_value"]:
            fail("sets table: index_str did not decode as str ids")
        from sybil_tpu_torch.ops.decode import decode_column_batch as dcb
        got = dcb(ids_main, C, dev)
        for bi in (0, len(ids_main) - 1):
            host = blocks.decode_str_container(ids_main[bi])
            n = len(host.ids)
            if not (np.array_equal(got[0][bi, :n].cpu().numpy(), host.ids)
                    and np.array_equal(got[1][bi, :n].cpu().numpy(),
                                       host.valid)):
                fail(f"K6 ids: sets index_str block {bi} differs from the "
                     f"host decoder")
        del got
        say(f"K6 id mode == plain (tolerance 0) on the sets table's "
            f"index_str ({len(ids_main)} str-value blocks) and the host "
            f"decoder")
        k6_edge_checks(card, dev, errs)

        # ---- phase 4: K2-K5 ----------------------------------------------
        cols, _ = decoded_cols(table, ["host", "ping", "status", "weight"],
                               C, dev)
        B = len(dirs)
        R = B * C
        nrec_np = np.array([table.block_infos()[d].num_records
                            for d in dirs], dtype=np.int32)
        nrec = torch.from_numpy(nrec_np).to(dev)
        configs = {
            "host/avg ping": (["host"], ["ping"], ""),
            "host/avg ping, weight column": (["host"], ["ping"], "weight"),
            "host,status,weight/avg ping,weight,ping":
                (["host", "status", "weight"], ["ping", "weight", "ping"],
                 ""),
            "host/avg weight (vbias)": (["host"], ["weight"], ""),
        }
        cfg1 = None
        for label, (g, a, w) in configs.items():
            cfg = bound_config(table, flags, g, a, w)
            sub = {k: cols[k] for k in set(g) | set(a) | ({w} - {""})}
            scan_check(label, cfg, sub, nrec, errs)
            plan = scan.dense_table_plan(cfg, R)
            say(f"K2/K3 == plain: {label}: slots={cfg.dense_slots} "
                f"Sc={scan.reduce_space(cfg)[1]} "
                f"path={scan.dense_scan_path(cfg)} i32={plan['i32']} "
                f"vbias={cfg.agg_vbias}")
            if cfg1 is None:
                cfg1 = cfg
        if scan.dense_scan_path(bound_config(
                table, flags, *configs["host,status,weight/avg ping,"
                                       "weight,ping"])) != "global":
            fail("the three-key config did not take the global-atomic path")
        part = nrec_np.copy()
        part[0] = 0
        part[-1] = min(part[-1], 1000)
        sub1 = {k: cols[k] for k in ("host", "ping")}
        scan_check("partial blocks", cfg1, sub1,
                   torch.from_numpy(part).to(dev), errs)
        kb = list(cfg1.key_bounds)
        kb[0] = (0, 3)
        narrow = dataclasses.replace(cfg1, key_bounds=tuple(kb))
        k2n, _ = scan_check("spilling key bound", narrow, sub1, nrec, errs)
        if int(k2n["spill"].item()) <= 0:
            fail("the narrowed key bound did not spill")

        # configs 3 and 2 as run_query binds them
        c3_filters = (("status", "eq", "200", "str"),)
        c2_filters = (("action", "neq", "pageload", "str"),
                      ("weight", "gt", "5", "int"))
        hist_q = {
            "config 3": (table, flags, query_params(
                ["host"], ["ping"], op="hist", filters=c3_filters)),
            "config 3 -loghist": (table, flags, query_params(
                ["host"], ["ping"], op="hist", htype="multi",
                filters=c3_filters)),
            "config 2": (stable, sflags, query_params(
                ["action", "page"], ["weight"], op="hist",
                filters=c2_filters)),
        }
        scols, sdirs = decoded_cols(stable, ["action", "page", "weight"], C,
                                    dev)
        snrec = torch.from_numpy(np.array(
            [stable.block_infos()[d].num_records for d in sdirs],
            dtype=np.int32)).to(dev)
        bound = {}
        for label, (t, f, params) in hist_q.items():
            b = bound_query(t, f, params)
            bound[label] = b
            src, n_ = (scols, snrec) if t is stable else (cols, nrec)
            sub = {k: src[k] for k in b.needed_cols}
            fv = device_const(b.filter_vals, dev)
            bits = tuple(device_const(x, dev) for x in b.bitsets)
            k2, main = scan_check(label, b.config, sub, n_, errs, fv, bits)
            agg = b.config.aggs[0]
            say(f"K2/K4/K5/K3 == plain: {label}: slots="
                f"{b.config.dense_slots} Sc={scan.reduce_space(b.config)[1]}"
                f" nv={agg.num_values} subs={len(agg.sub_edges)} "
                f"K2 path={scan.dense_scan_path(b.config)} K4 path="
                f"{scan.dense_hist_path(b.config, 0)} track_outliers="
                f"{b.config.track_outliers} groups={int(main[0, 0])} "
                f"nout={int(main[0, 2])}")
        # config 4 as run_query binds it, on both decoded tables; its
        # -op hist form with outlier tracking forced on (the bench data
        # cannot overflow the hist range, so its outlier rows are the
        # padding rows, whose time key K5 writes too); and the bulk
        # table's rows shuffled on the card, as a table written in
        # arrival order would hold them, windowed as the bind windows
        # blocks that span the whole range (the CPU tests' wide table)
        params4 = query_params(["action"], ["weight"],
                               time_bucket=C4_BUCKET)
        c4 = {}
        for tlabel, (t4, f4) in tables4.items():
            b4 = bound_query(t4, f4, params4)
            cols4, dirs4 = decoded_cols(t4, ["time", "action", "weight"], C,
                                        dev)
            nrec4 = torch.from_numpy(np.array(
                [t4.block_infos()[d].num_records for d in dirs4],
                dtype=np.int32)).to(dev)
            c4[tlabel] = (b4.config, cols4, nrec4)
            k2t, _ = scan_check(f"config 4 {tlabel}", b4.config, cols4,
                                nrec4, errs, tb=C4_BUCKET)
            hcfg = dataclasses.replace(bound_query(t4, f4, query_params(
                ["action"], ["weight"], op="hist",
                time_bucket=C4_BUCKET)).config, track_outliers=True)
            _, hmain = scan_check(f"config 4 -op hist {tlabel}", hcfg,
                                  cols4, nrec4, errs, tb=C4_BUCKET)
            band, chunk = scan.window_band(b4.config, C)
            say(f"K2/K3 == plain: config 4 {tlabel}: slots="
                f"{b4.config.dense_slots} window={b4.config.window} "
                f"window_chunk={b4.config.window_chunk} band={band} "
                f"chunk={chunk} time_i32={b4.config.time_i32} key_bounds="
                f"{b4.config.key_bounds} path="
                f"{scan.dense_scan_path(b4.config)} spill="
                f"{int(k2t['spill'].item())}; -op hist K2/K4/K5/K3 == "
                f"plain (K4 {scan.dense_hist_path(hcfg, 0)}, outlier rows "
                f"{int(hmain[0, 2])})")
            if int(k2t["spill"].item()) != 0:
                fail(f"config 4 {tlabel}: exact bounds spilled")
        cfg4b, cols4b, nrec4b = c4["bulk"]
        # the records of every block (rows below its nrec), permuted
        # among themselves
        pos = torch.nonzero((torch.arange(C, device=dev)[None, :]
                             < nrec4b[:, None]).reshape(-1)).reshape(-1)
        perm = pos[torch.randperm(pos.numel(), device=dev,
                                  generator=torch.Generator(dev)
                                  .manual_seed(4))]
        cols4s = {}
        for k, (v, m) in cols4b.items():
            v2, m2 = v.clone().reshape(-1), m.clone().reshape(-1)
            v2[pos], m2[pos] = v.reshape(-1)[perm], m.reshape(-1)[perm]
            cols4s[k] = (v2.reshape(v.shape), m2.reshape(m.shape))
        nrec4s = nrec4b
        cfg4s = dataclasses.replace(cfg4b, window=896)
        if not scan.windowed(cfg4s):
            fail("the arrival-order config 4 is not windowed")
        scan_check("config 4 arrival order", cfg4s, cols4s, nrec4s, errs,
                   tb=C4_BUCKET)
        c4["arrival order"] = (cfg4s, cols4s, nrec4s)
        say("K2 (windowed and global) and K3 == plain: config 4 with the "
            "bulk table's rows in arrival order, window 896")
        # the windowed form's paths: its corner cases and config 4's
        # three layouts
        k2w_edge_checks(card, dev, errs, [
            (f"config 4 {tl}", cfg, cols_, nrec_, None, (), C4_BUCKET, None)
            for tl, (cfg, cols_, nrec_) in c4.items()])
        k2_edge_checks(card, dev, errs)
        k4_edge_checks(card, dev, errs)
        k13_edge_checks(card, dev, errs)

        for label in EDGE_SCANS:
            cfg, ecols, enrec, efv, ebits, etb = edge_scan(label, dev)
            k2e, emain = scan_check(label, cfg, ecols, enrec, errs, efv,
                                    ebits, etb)
            if (int(k2e["spill"].item()) > 0) != ("spill" in label):
                fail(f"edge scan {label}: unexpected spill "
                     f"{k2e['spill'].item()}")
            if label == "outliers beyond the packed rows" and \
                    int(emain[0, 2]) <= 16:
                fail(f"edge scan {label}: only {int(emain[0, 2])} outliers")
            if label == "hist table in global memory" and \
                    scan.dense_hist_path(cfg, 0) != "global":
                fail(f"edge scan {label}: K4 took the shared path")
            if label == "time: span wider than 8 bands":
                # 8 of the reference's bands (the bind's window)
                band = cfg.window
                sums = scan.dense_scan_plain(cfg, ecols, enrec, efv, ebits,
                                             etb)["sums"]
                live = torch.nonzero(sums[:, 1]).reshape(-1)
                span = int(live.max() - live.min()) + 1
                if span <= 8 * band:
                    fail(f"edge scan {label}: span {span} <= 8 bands of "
                         f"{band}")
            if label == "time: hist, tracked outliers" and \
                    int(emain[0, 2]) == 0:
                fail(f"edge scan {label}: no outlier rows")
        say(f"K2-K5 == plain on {len(EDGE_SCANS)} synthetic edge batches "
            f"(3 x 65536 rows): " + ", ".join(EDGE_SCANS))
        say("K2 dense_scan (time key; shared, global and windowed forms), "
            "K4 dense_hist, K5 outlier_compact (time key) and K3 dense_pack "
            "== plain, word for word (tolerance 0)")

        # ---- phase 4: the sorted strategy (K7-K10, sort_permute, K5) ----
        # path 1: config 3 with -tdigest, as run_query binds it
        b_p1 = bound_query(table, flags, query_params(
            ["host"], ["ping"], op="hist", htype="tdigest",
            filters=c3_filters))
        cfg_p1 = b_p1.config
        cols_p1 = {k: cols[k] for k in b_p1.needed_cols}
        fv_p1 = device_const(b_p1.filter_vals, dev)
        bits_p1 = tuple(device_const(x, dev) for x in b_p1.bitsets)
        if not scan.sort_packed(cfg_p1) or \
                scan.pack_sentinel(cfg_p1)[1] != torch.int32:
            fail(f"path 1: not an int32 packed sort: {cfg_p1.sort_pack}")
        main_p1, _, parts_p1 = sorted_check(
            "path 1 (config 3 -tdigest)", cfg_p1, cols_p1, nrec, errs,
            fv_p1, bits_p1)
        agg_p1 = cfg_p1.aggs[0]
        want_pairs = numpy_pairs(up["host"], up["status"], up["ping"],
                                 agg_p1)
        hp = parts_p1["pairs"][0]
        idx = torch.nonzero(hp["hp_mask"]).reshape(-1)
        hosts_dict = table.dicts.get("host").strings
        got_pairs = {}
        for k, bv, w in zip(hp["hp_keys"][idx, 0].tolist(),
                            hp["hp_bv"][idx].tolist(), hp["hp_w"][idx].tolist()):
            got_pairs[(hosts_dict[k], agg_p1.hist_min
                       + bv * agg_p1.bucket_size)] = w
        if got_pairs != want_pairs:
            fail(f"path 1: the device's (host, ping) pairs differ from "
                 f"numpy: {len(got_pairs)} vs {len(want_pairs)}")
        say(f"K7/K8/K9/K5/K10 == plain: path 1 (config 3 -tdigest): "
            f"int32 packed key, nv={agg_p1.num_values} bs="
            f"{agg_p1.bucket_size}, groups={int(main_p1[0, 0])} (sentinel "
            f"segment included), hist pairs={len(got_pairs)} == numpy's "
            f"(host, ping) counts, outliers={int(main_p1[0, 2])}")
        # path 2: config 4 at 5-minute buckets on both user_sessions tables
        params_p2 = query_params(["action"], ["weight"], time_bucket=P2_BUCKET)
        p2 = {}
        for tlabel, (t4, f4) in tables4.items():
            cfg4, cols4, nrec4 = c4[tlabel]
            cfg_p2 = bound_query(t4, f4, params_p2).config
            if cfg_p2.strategy != "sorted" or scan.sort_packed(cfg_p2):
                fail(f"path 2 {tlabel}: strategy {cfg_p2.strategy}, packed "
                     f"{scan.sort_packed(cfg_p2)}")
            main_p2, table_p2, parts = sorted_check(
                f"path 2 (config 4, 5-minute buckets) {tlabel}", cfg_p2,
                cols4, nrec4, errs, tb=P2_BUCKET)
            ng = int(main_p2[0, 0])
            if ng <= scan.table_prefix(cfg_p2):
                fail(f"path 2 {tlabel}: {ng} groups fit the prefix")
            p2[tlabel] = (cfg_p2, cols4, nrec4, parts)
            say(f"K7/sort_permute/K8/K10 == plain: path 2 (config 4, "
                f"{P2_BUCKET} s buckets) {tlabel}: unpacked keys (time, "
                f"action), time_i32={cfg_p2.time_i32}, groups={ng} "
                f"(prefix {scan.table_prefix(cfg_p2)}), table "
                f"{tuple(table_p2.shape)}")
        for label in SORTED_EDGES:
            cfg, ecols, enrec, efv, ebits, etb = sorted_edge(label, dev)
            emain, _, _ = sorted_check(label, cfg, ecols, enrec, errs, efv,
                                       ebits, etb)
            sorted_edge_expect(label, cfg, emain,
                               next(iter(ecols.values()))[0].numel())
        say(f"K7-K10, sort_permute and K5 (kmat keys) == plain on "
            f"{len(SORTED_EDGES)} synthetic sorted batches (3 x 65536 "
            f"rows): " + ", ".join(SORTED_EDGES))
        k8_edge_checks(card, dev, errs)
        k9_edge_checks(card, dev, errs)
        k5_edge_checks(card, dev, errs)
        k7_edge_checks(card, dev, errs)
        k10_edge_checks(card, dev, errs)
        k3_edge_checks(card, dev, errs)

        # ---- phase 4: the enumerated strategy and the device prune -----
        from sybil_tpu_torch import blocks as blocks5
        from sybil_tpu_torch.ops.decode import decode_column_batch

        def c5_batches(entry):
            """Config 5's real batches of one partition, as _scan_dirs
            builds them: device_batch blocks each, the last padded with
            repeats of its last block (records 0)."""
            t5, _, _, _, dirs5, _, _ = entry
            infos5 = t5.block_infos()
            maxrec = max(i.num_records for i in infos5.values())
            C5 = 65536 if maxrec > 8192 else 1 << (maxrec - 1).bit_length()
            out = []
            for s0 in range(0, len(dirs5), C5_BATCH):
                bd = dirs5[s0: s0 + C5_BATCH]
                pad = bd + [bd[-1]] * (C5_BATCH - len(bd))
                cols5 = {}
                for name in ("userid", "weight"):
                    typ = t5.schema.col_type(name)
                    v, m, _ = decode_column_batch(
                        [blocks5.open_column(d, typ, name) for d in pad], C5,
                        dev)
                    cols5[name] = (v, m)
                nr = np.zeros(C5_BATCH, np.int32)
                nr[:len(bd)] = [min(infos5[d].num_records, C5) for d in bd]
                out.append((cols5, torch.from_numpy(nr).to(dev)))
            return out

        c5_main = []
        for pi_, entry in enumerate(c5):
            cfg5 = entry[5]
            for bi, (cols5, nr5) in enumerate(c5_batches(entry)):
                main5, table5, parts5 = enum_check(
                    f"config 5 partition {pi_ + 1} batch {bi + 1}", cfg5,
                    cols5, nr5, errs)
                # -prune-sort weight: the f32 mean score on the same batch
                cfg5w = dataclasses.replace(cfg5, prune_agg=0)
                _, table5w, _ = enum_check(
                    f"config 5 partition {pi_ + 1} batch {bi + 1}, f32 "
                    f"score", cfg5w, cols5, nr5, errs)
                enum_winners_expect(f"config 5 partition {pi_ + 1} batch "
                                    f"{bi + 1}", cfg5w, cols5, nr5, table5w)
                if pi_ == 0 and bi == 0:
                    c5_main = (cfg5, cols5, nr5, parts5)
                say(f"K7 (enum form)/K11/K12/K10 enum_pack == plain: config "
                    f"5 partition {pi_ + 1} batch {bi + 1}, $COUNT and f32 "
                    f"mean scores (the mean's winners == numpy's): radix "
                    f"{scan.enum_radix(cfg5)}, live groups "
                    f"{int(main5[0, 0])}, pruned {int(main5[0, 4])}, totals "
                    f"({int(main5[0, 5])}, {int(main5[0, 6])}), spill "
                    f"{int(main5[0, 1])}, top count {int(main5[1, 1])}")
        # the sorted strategy's device prune on config 5's batch: the same
        # bind without the packed key
        cfg5, cols5, nr5, _ = c5_main
        cfg_sp = dataclasses.replace(cfg5, sort_pack=())
        if scan.enum_radix(cfg_sp) or cfg_sp.strategy != "sorted":
            fail("config 5 without sort_pack is not the sorted strategy")
        main_sp, table_sp, _ = sorted_check(
            "config 5, sorted device prune (unpacked key)", cfg_sp, cols5,
            nr5, errs)
        if int(main_sp[0, 4]) != scan.table_prefix(cfg_sp):
            fail("the sorted device prune set no pruned marker")
        for wk in (-1, 0):
            cfg_m = dataclasses.replace(cfg_sp, prune_agg=wk)
            sorted_check(f"config 5, sorted device prune, prune_agg {wk}",
                         cfg_m, cols5, nr5, errs)
        say(f"K7/sort/K8/K10 (prune form)/K12 and its gather == plain: config "
            f"5's batch on the sorted strategy, $COUNT and mean scores over "
            f"{cfg_sp.max_groups} slots, pruned {int(main_sp[0, 4])}")
        for label in ENUM_EDGES:
            cfg, ecols, enrec, efv, ebits = enum_edge(label, dev)
            emain, _, _ = enum_check(label, cfg, ecols, enrec, errs, efv,
                                     ebits)
            enum_edge_expect(label, cfg, emain)
        for label, sc, kk in topk_edges(dev):
            check_equal(f"topk_rows {label}", scan.topk_rows(sc, kk),
                        scan.topk_rows_plain(sc, kk), errs["topk_rows"])
        k12g_edge_checks(card, dev, errs)
        k11_edge_checks(card, dev, errs)
        say(f"K7 (enum form), K11, K12 and K10 enum_pack == plain on "
            f"{len(ENUM_EDGES)} synthetic enumerated batches: "
            + ", ".join(ENUM_EDGES) + "; K12 alone on "
            + ", ".join(label for label, _, _ in topk_edges(dev)))

        # ---- phase 4: count distinct and the former fixed caps ---------
        # K13 and K3's HLL sections on the decoded uptime batch: the int
        # fast path (index_int: every value distinct), a str column's
        # hash array (the reference's pair form), and the same with the
        # hash array padded past the pair form (its row form)
        icols, _ = decoded_cols(table, ["index_int"], C, dev)
        ucols = dict(cols, index_int=icols["index_int"])
        del icols
        hll_ctx = {}
        for label, g, d in (("group by host, distinct index_int", "host",
                             "index_int"),
                            ("group by host, distinct status", "host",
                             "status"),
                            ("group by status, distinct host, the hash "
                             "array padded past the pair form", "status",
                             "host")):
            bd = bound_query(table, flags, query_params([g], [],
                                                        distincts=[d]))
            cfg = bd.config
            if not cfg.hll or cfg.strategy != "dense":
                fail(f"{label}: no device HLL ({cfg.strategy})")
            bits = list(dev_bits(bd.bitsets, dev))
            gsmall = 1 + int(np.prod([c + 1 for _, c in cfg.key_bounds]))
            if "padded" in label:
                # the missing value's hash stays the last entry
                hs = bd.bitsets[cfg.hll_hash_idx]
                pad = np.random.default_rng(7).integers(
                    0, 2 ** 63, 40000, dtype=np.uint64)
                big = np.concatenate([hs[:-1], pad, hs[-1:]])
                bits[cfg.hll_hash_idx] = torch.from_numpy(
                    big.view(np.int64)).to(dev)
            nd = bits[cfg.hll_hash_idx].numel() if cfg.hll_hash_idx >= 0 \
                else 0
            form = ("rows (int)" if not nd else "pairs" if gsmall * nd
                    <= 32768 else "rows")
            sub = {k: ucols[k] for k in bd.needed_cols}
            k2h, mainh = scan_check(label, cfg, sub, nrec, errs, None,
                                    tuple(bits))
            hll_ctx[label] = (cfg, sub, tuple(bits), k2h)
            say(f"K2/K13/K3 (HLL sections) == plain: {label}: slots="
                f"{cfg.dense_slots} Sc={scan.reduce_space(cfg)[1]} hash "
                f"array {nd} entries, the reference's {form} form, live "
                f"groups {int(mainh[0, 0])}, Phll "
                f"{scan.packed_layout(cfg, R)['Phll']}")
        # K7's distinct lanes, the sorts, K8's pair mask and K10's pair
        # section: group by host, distinct status, ping (its pairs fit the
        # packed section), and config 5's partition 1 grouped by userid,
        # distinct weight (past max_pairs)
        pair_ctx = {}
        t5_1, f5_1 = c5[0][0], c5[0][1]
        for label, t, f, g, ds, sub_src, nr in (
                ("group by host, distinct status, ping", table, flags,
                 ["host"], ["status", "ping"], ucols, nrec),
                ("config 5 partition 1, group by userid, distinct weight",
                 t5_1, f5_1, ["userid"], ["weight"], c5_main[1],
                 c5_main[2])):
            bd = bound_query(t, f, query_params(g, [], distincts=ds))
            cfg = bd.config
            sub = {k: sub_src[k] for k in bd.needed_cols}
            Rn = nr.numel() * next(iter(sub.values()))[0].shape[1]
            mainq, _, parts = sorted_check(label, cfg, sub, nr, errs, None,
                                           dev_bits(bd.bitsets, dev))
            kmax = scan.packed_layout(cfg, Rn)["kmax_pairs"]
            npairs = int(mainq[0, 2])
            if npairs <= 0 or (npairs > kmax) != ("config 5" in label):
                fail(f"{label}: {npairs} pairs against {kmax} packed rows")
            pair_ctx[label] = (cfg, sub, nr, parts)
            say(f"K7 (distinct lanes)/sorts/K8 (pair mask)/K10 (pair "
                f"section) == plain: {label}: K + D = {cfg.n_all_keys} "
                f"lanes, groups {int(mainq[0, 0])}, pairs {npairs} "
                f"(packed section {kmax} rows)")
        for line in distinct_edges_check(dev, errs):
            say(f"  distinct or C1 edge batch == plain: {line}")
        say(f"K13, K3's HLL sections, K7's distinct lanes, K8's pair mask, "
            f"K10's pair section, and K2, K5, K7, K8, K10, K11 at 17 "
            f"filters, 17 keys and 33 aggregations, and past the "
            f"descriptor words a launch carries (60 filters, 50 and 60 "
            f"aggregations) == plain on {len(DISTINCT_EDGES)} synthetic "
            f"batches (tolerance 0)")

        # ---- phase 4: set filters and the matched mask ----------------
        sets_ctx = sets_kernel_checks(card, stbl, stflags, sarr, C, dev,
                                      errs)

        # ---- phase 5: the main path ------------------------------------
        launches = {k: 0 for k in COUNTED}
        want = numpy_groupby(up["host"], up["ping"])
        argv_q = ["query", "-dir", table.flags.dir, "-table", "uptime",
                  "-group", "host", "-int", "ping", "-op", "avg", "-json",
                  "-device-batch", str(B), "-device", "cuda"]
        residency.CACHE.clear()
        rc, out, cli_wall, l1 = run_cli(argv_q)
        if rc != 0:
            fail(f"port CLI query exited {rc}")
        if any(l1[k] == 0 for k in ("decode_bucket2", "dense_scan",
                                    "dense_pack")):
            fail(f"a kernel of the config-1 path never launched: {l1}")
        rows = json.loads(out)
        got = {r["host"]: r for r in rows}
        if set(got) != set(want):
            fail(f"groups differ: {sorted(got)} vs {sorted(want)}")
        for h, (cnt, s) in want.items():
            r = got[h]
            if r["Count"] != cnt or r["Samples"] != cnt or r["ping"] != s / cnt:
                fail(f"group {h}: port {r} vs numpy count={cnt} sum={s}")
        say(f"main path: CLI query group by host avg ping on cuda == numpy "
            f"group-by ({len(want)} groups, {args.rows} rows); launches "
            f"{l1}; wall {cli_wall:.3f}s")
        tally(launches, l1)

        hist_argv = {
            "config 3": ["-group", "host", "-int", "ping", "-op", "hist",
                         "-str-filter", "status:eq:200"],
            "config 3 -loghist": ["-group", "host", "-int", "ping", "-op",
                                  "hist", "-str-filter", "status:eq:200",
                                  "-loghist"],
            "config 2": ["-group", "action,page", "-int", "weight", "-op",
                         "hist", "-str-filter", "action:neq:pageload",
                         "-int-filter", "weight:gt:5"],
        }
        residency.CACHE.clear()
        for label, extra in hist_argv.items():
            t, _, _ = hist_q[label]
            tname = "user_sessions" if t is stable else "uptime"
            nb = len(t.block_infos())
            rc, out, wall, ll = run_cli(
                ["query", "-dir", t.flags.dir, "-table", tname, *extra,
                 "-json", "-device-batch", str(nb), "-device", "cuda"])
            if rc != 0:
                fail(f"{label}: port CLI query exited {rc}")
            agg = bound[label].config.aggs[0]
            if t is stable:
                gidx = us["action"] * len(pages) + us["page"]
                matched = (us["action"] != actions.index("pageload")) & \
                    (us["weight"] > 5)
                wanth = numpy_hist(gidx, len(actions) * len(pages), matched,
                                   us["weight"], agg)
                ng, nout = check_hist_json(
                    label, json.loads(out), agg, wanth,
                    lambda g: (actions[g // len(pages)],
                               pages[g % len(pages)]), ("action", "page"))
            else:
                wanth = numpy_hist(up["host"], len(HOSTS),
                                   up["status"] == STATII.index("200"),
                                   up["ping"], agg)
                ng, nout = check_hist_json(
                    label, json.loads(out), agg, wanth,
                    lambda g: (HOSTS[g],), ("host",))
            if ll["dense_scan"] != 1 or ll["dense_pack"] != 1 or \
                    ll["dense_hist"] != 1:
                fail(f"{label}: expected K2, K4 and K3 once: {ll}")
            if ll["outlier_compact"] != int(bound[label].config
                                            .track_outliers):
                fail(f"{label}: K5 launches {ll} vs track_outliers "
                     f"{bound[label].config.track_outliers}")
            say(f"main path: CLI {label} on cuda == numpy group-by ({ng} "
                f"groups, {args.rows} rows, count, sum, bucket counts, "
                f"{nout} outliers); launches {ll}; wall {wall:.3f}s")
            tally(launches, ll)
        # config 4 on both user_sessions tables, cold (cache cleared)
        want4 = numpy_rollup(us["time"], us["action"], us["weight"],
                             C4_BUCKET)
        cold4 = dict({k: 0 for k in COUNTED}, decode_bucket2=2,
                     decode_value=1, dense_scan=1, dense_pack=1)
        for tlabel, (t4, _) in tables4.items():
            residency.CACHE.clear()
            nb = len(t4.block_infos())
            rc, out, wall, ll = run_cli(
                ["query", "-dir", t4.flags.dir, "-table", "user_sessions",
                 "-group", "action", "-int", "weight", "-op", "avg",
                 "-time", "-time-bucket", str(C4_BUCKET), "-time-col",
                 "time", "-json", "-device-batch", str(nb),
                 "-device", "cuda"])
            if rc != 0:
                fail(f"config 4 {tlabel}: port CLI query exited {rc}")
            if ll != cold4:
                fail(f"config 4 {tlabel}: cold launches {ll}, expected "
                     f"{cold4}")
            got4 = {}
            for tb_s, rows_ in json.loads(out).items():
                for r in rows_:
                    got4[(int(tb_s), actions.index(r["action"]))] = r
            if set(got4) != set(want4):
                fail(f"config 4 {tlabel}: (time bucket, action) keys "
                     f"differ: {len(got4)} vs numpy {len(want4)}")
            for k, (cnt, wsum) in want4.items():
                r = got4[k]
                if r["Count"] != cnt or r["Samples"] != cnt or \
                        r["weight"] != wsum / cnt:
                    fail(f"config 4 {tlabel} {k}: port {r} vs numpy "
                         f"count={cnt} sum={wsum}")
            say(f"main path: CLI config 4 on cuda, {tlabel} table == numpy "
                f"group-by ({len(want4)} (time bucket, action) rows, "
                f"{args.rows} rows, count and weight sum each); cold "
                f"launches {ll}; wall {wall:.3f}s")
            tally(launches, ll)

        # path 1 through the CLI, cold: -tdigest on uptime.  The (host,
        # ping) pairs the engine absorbs are recorded on their way in
        from sybil_tpu_torch.query import engine as port_engine
        absorbed = []
        real_absorb = port_engine._Accumulator._absorb_hist_pairs

        def record_pairs(self, ai, hkeys, hbv, hw, spec):
            absorbed.append((hkeys.copy(), hbv.copy(), hw.copy()))
            return real_absorb(self, ai, hkeys, hbv, hw, spec)

        residency.CACHE.clear()
        port_engine._Accumulator._absorb_hist_pairs = record_pairs
        try:
            rc, out, wall, ll = run_cli(
                ["query", "-dir", table.flags.dir, "-table", "uptime",
                 *P1_ARGV, "-json", "-device-batch", str(B), "-device",
                 "cuda"])
        finally:
            port_engine._Accumulator._absorb_hist_pairs = real_absorb
        if rc != 0:
            fail(f"path 1: port CLI query exited {rc}")
        # K5 runs when the bind tracks outliers; exact bounds that prove
        # the value-identity buckets hold every kept ping turn it off
        track1 = int(cfg_p1.track_outliers)
        cold1 = dict({k: 0 for k in COUNTED}, decode_bucket2=3,
                     sorted_front=1, segment_reduce=1, hist_prep=1,
                     hist_pairs=1, outlier_compact=track1, sorted_pack=1)
        if ll != cold1:
            fail(f"path 1: cold launches {ll}, expected {cold1}")
        got_pairs = {}
        for hkeys, hbv, hw in absorbed:
            for k, bv, w in zip(hkeys[:, 0].tolist(), hbv.tolist(),
                                hw.tolist()):
                key = (hosts_dict[k] if k >= 0 else "",
                       agg_p1.hist_min + bv * agg_p1.bucket_size)
                got_pairs[key] = got_pairs.get(key, 0) + w
        if got_pairs != want_pairs:
            fail(f"path 1: the engine's (host, ping) pairs differ from "
                 f"numpy: {len(got_pairs)} vs {len(want_pairs)}")
        rows = {r["host"]: r for r in json.loads(out)}
        ok200 = up["status"] == STATII.index("200")
        for i, h in enumerate(HOSTS):
            sel = (up["host"] == i) & ok200
            n_kept = sum(c for (hh, _), c in want_pairs.items() if hh == h)
            s_kept = sum(v * c for (hh, v), c in want_pairs.items()
                         if hh == h)
            r = rows.get(h)
            if r is None or r["Count"] != int(sel.sum()) or \
                    r["Samples"] != int(sel.sum()) or \
                    r["ping"]["samples"] != n_kept:
                fail(f"path 1 host {h}: port {r} vs numpy count "
                     f"{int(sel.sum())}, kept {n_kept}")
            if r["ping"]["percentiles"] != numpy_tdigest_percentiles(
                    want_pairs, h, agg_p1):
                fail(f"path 1 host {h}: percentiles differ from a t-digest "
                     f"of numpy's pairs")
            if s_kept != int(up["ping"][sel & (up["ping"] >= agg_p1.
                                               discard_min)
                                        & (up["ping"] <= agg_p1.
                                           discard_max)].sum()):
                fail(f"path 1 host {h}: pairs do not sum to Σping")
        if set(rows) != set(HOSTS):
            fail(f"path 1: groups {sorted(rows)}")
        say(f"main path: CLI path 1 (config 3 -tdigest) on cuda == numpy "
            f"group-by ({len(rows)} hosts, {args.rows} rows: count, kept "
            f"rows, {len(want_pairs)} (host, ping) pairs with their counts, "
            f"percentiles of a t-digest of numpy's pairs); cold launches "
            f"{ll}; wall {wall:.3f}s")
        tally(launches, ll)

        # path 2 through the CLI, cold, on both user_sessions tables
        want_p2 = numpy_rollup(us["time"], us["action"], us["weight"],
                               P2_BUCKET)
        cold2 = dict({k: 0 for k in COUNTED}, decode_bucket2=2,
                     decode_value=1, sorted_front=1, sort_permute=1,
                     segment_reduce=1, sorted_pack=1)
        for tlabel, (t4, _) in tables4.items():
            residency.CACHE.clear()
            nb = len(t4.block_infos())
            rc, out, wall, ll = run_cli(
                ["query", "-dir", t4.flags.dir, "-table", "user_sessions",
                 *P2_ARGV, "-json", "-device-batch", str(nb), "-device",
                 "cuda"])
            if rc != 0:
                fail(f"path 2 {tlabel}: port CLI query exited {rc}")
            if ll != cold2:
                fail(f"path 2 {tlabel}: cold launches {ll}, expected "
                     f"{cold2}")
            got2 = {}
            for tb_s, rows_ in json.loads(out).items():
                for r in rows_:
                    got2[(int(tb_s), actions.index(r["action"]))] = r
            if set(got2) != set(want_p2):
                fail(f"path 2 {tlabel}: (time bucket, action) keys differ: "
                     f"{len(got2)} vs numpy {len(want_p2)}")
            for k, (cnt, wsum) in want_p2.items():
                r = got2[k]
                if r["Count"] != cnt or r["Samples"] != cnt or \
                        r["weight"] != wsum / cnt:
                    fail(f"path 2 {tlabel} {k}: port {r} vs numpy "
                         f"count={cnt} sum={wsum}")
            say(f"main path: CLI path 2 (config 4, {P2_BUCKET} s buckets) on "
                f"cuda, {tlabel} table == numpy group-by ({len(want_p2)} "
                f"(time bucket, action) rows, {args.rows} rows, count and "
                f"weight sum each); cold launches {ll}; wall {wall:.3f}s")
            tally(launches, ll)

        # a dense key bound that spills, retried on the sorted strategy
        sroot, snb, want_s = spill_table(os.path.join(root, "spill"))
        seen = []
        real_scan = scan.scan_packed

        def record_strategy(cfg, *a, **kw):
            seen.append(cfg.strategy)
            return real_scan(cfg, *a, **kw)

        scan.scan_packed = record_strategy
        try:
            rc, out, wall, ll = run_cli(
                ["query", "-dir", sroot, "-table", "spill", "-group", "g",
                 "-int", "v", "-json", "-device-batch", "2", "-device",
                 "cuda"])
        finally:
            scan.scan_packed = real_scan
        if rc != 0:
            fail(f"spill retry: port CLI query exited {rc}")
        nbatch = -(-snb // 2)
        if not seen or seen[0] != "dense" or \
                seen[-nbatch:] != ["sorted"] * nbatch or \
                seen.count("sorted") != nbatch:
            fail(f"spill retry: strategies {seen}, expected dense, then "
                 f"{nbatch} sorted batches")
        got_s = {r["g"]: (r["Count"], r["v"]) for r in json.loads(out)}
        if got_s != {k: (c, sv / c) for k, (c, sv) in want_s.items()}:
            fail(f"spill retry: result differs from numpy: {got_s}")
        say(f"spill retry on cuda: {snb} blocks, strategies {seen} "
            f"(dense spilled, every batch rescanned sorted); result == numpy "
            f"group-by ({len(want_s)} groups, the 1,000,000 key past its "
            f"IntInfo bound included); launches {ll}")

        # config 5 through the CLI, cold: each partition answers `query
        # -encode-results` (a node of the reference's protocol), then
        # `aggregate` merges the two result directories on the host
        resdir = os.path.join(root, "c5_results")
        os.makedirs(resdir)
        want5 = [numpy_users(e[2], e[3]) for e in c5]

        def enum_launches(nb):
            return {"sorted_front": nb, "enum_segments": nb, "topk_rows": nb,
                    "enum_pack": nb, "sorted_pack": 0, "prune_gather": 0,
                    "segment_reduce": 0, "dense_scan": 0}

        def check_users(label, rows, cnt, ws, exact=True):
            """Every printed group's count and mean weight against numpy;
            -> the printed counts."""
            for r in rows:
                u = int(r["userid"][len("person"):])
                mean = ws[u] / cnt[u] if cnt[u] else None
                ok = r["Count"] == cnt[u] and r["Samples"] == cnt[u] and (
                    r["weight"] == mean if exact else
                    abs(r["weight"] - mean) <= 1e-12 * mean)
                if not ok:
                    fail(f"{label} user {u}: port {r} vs numpy count "
                         f"{cnt[u]} weight sum {ws[u]}")
            return sorted(r["Count"] for r in rows)

        def top_counts(cnt, n=100):
            return sorted(np.sort(cnt)[-n:].tolist())

        shipped = 0       # numpy's rows of the groups the nodes ship
        for pi_, (t5, f5, uid5, w5, dirs5, cfg5, nb5) in enumerate(c5):
            residency.CACHE.clear()
            rc, out, wall, ll = run_cli(
                ["query", "-dir", t5.flags.dir, *C5_ARGV, "-encode-results",
                 "-device-batch", str(C5_BATCH), "-device", "cuda"])
            if rc != 0:
                fail(f"config 5 partition {pi_ + 1}: port CLI exited {rc}")
            for k, n in enum_launches(nb5).items():
                if ll[k] != n:
                    fail(f"config 5 partition {pi_ + 1}: {k} launched "
                         f"{ll[k]}x, expected {n}: {ll}")
            with open(os.path.join(resdir, f"node{pi_ + 1}.json"), "w") as f:
                f.write(out)
            spec = json.loads(out)["QuerySpec"]
            cnt, ws = want5[pi_]
            for r in spec["results"]:
                u = int(r["group_key"].split("\t")[0][len("person"):])
                h = r["hists"]["weight"]
                if r["count"] != cnt[u] or h["avg"] != ws[u] / cnt[u]:
                    fail(f"config 5 node {pi_ + 1} user {u}: shipped count "
                         f"{r['count']} avg {h['avg']} vs numpy {cnt[u]}, "
                         f"{ws[u]}")
                shipped += int(cnt[u])
            if (spec["cumulative"]["count"] != len(uid5)
                    or spec["matched_count"] != len(uid5)):
                fail(f"config 5 node {pi_ + 1}: Cumulative "
                     f"{spec['cumulative']['count']}, matched "
                     f"{spec['matched_count']}, rows {len(uid5)}")
            say(f"main path: CLI config 5 partition {pi_ + 1} -encode-results "
                f"on cuda: {len(spec['results'])} groups shipped, each "
                f"group's count and mean weight == numpy; Cumulative and "
                f"matched == {len(uid5)} rows; cold launches {ll}; wall "
                f"{wall:.3f}s")
            tally(launches, ll)

        def run_aggregate(extra):
            """`aggregate` in-process over the results directory, with an
            empty stdin (no encoded flags)."""
            old_stdin = sys.stdin
            sys.stdin = io.StringIO("")
            try:
                return run_cli(["aggregate", *C5_ARGV[2:], *extra, resdir])
            finally:
                sys.stdin = old_stdin

        rc, out, agg_wall, la = run_aggregate(["-json"])
        if rc != 0 or any(la.values()):
            fail(f"aggregate exited {rc}, launches {la}")
        cnt_all = want5[0][0] + want5[1][0]
        ws_all = want5[0][1] + want5[1][1]
        # the reference's merge averages the nodes' float means
        # (aggregator.py merge_results -> BasicHist.combine): the mean
        # weight is held to 1e-12 relative, counts exactly
        got_counts = check_users("aggregate", json.loads(out), cnt_all,
                                 ws_all, exact=False)
        if got_counts != top_counts(cnt_all):
            fail("aggregate: the printed counts are not numpy's top-100")
        # TOTAL merges the groups the nodes shipped (aggregator.py
        # aggregate_specs), not the nodes' Cumulative rows
        rc, text, _, _ = run_aggregate([])
        total_line = text.splitlines()[0]
        if (rc != 0 or total_line.split()[:2] != ["TOTAL", str(shipped)]):
            fail(f"aggregate text output starts with {total_line!r}, not "
                 f"TOTAL {shipped} (numpy's rows of the shipped groups)")
        say(f"main path: aggregate over both nodes == numpy over "
            f"{args.rows} rows: 100 groups, counts == numpy's top-100 "
            f"counts, mean weights within 1e-12; the nodes' Cumulative "
            f"counts sum to {sum(len(e[2]) for e in c5)}; text begins "
            f"{total_line!r} (== numpy's rows of the shipped groups); wall "
            f"{agg_wall:.3f}s, no kernel launched")
        # the f32 score: prune by the weight's mean; and a multi-batch
        # scan (device_batch 16), where the host prune runs too
        t5, f5, uid5, w5, dirs5, cfg5, nb5 = c5[0]
        cnt1, ws1 = want5[0]
        for label, extra, nb in (
                ("-prune-sort weight", ["-prune-sort", "weight"], nb5),
                ("device_batch 16", ["-device-batch", "16"],
                 -(-len(dirs5) // 16))):
            residency.CACHE.clear()
            rc, out, wall, ll = run_cli(
                ["query", "-dir", t5.flags.dir, *C5_ARGV, "-json",
                 "-device-batch", str(C5_BATCH), *extra, "-device", "cuda"])
            if rc != 0:
                fail(f"config 5 {label}: port CLI exited {rc}")
            for k, n in enum_launches(nb).items():
                if ll[k] != n:
                    fail(f"config 5 {label}: {k} launched {ll[k]}x, "
                         f"expected {n}: {ll}")
            rows5 = json.loads(out)
            counts = check_users(f"config 5 {label}", rows5, cnt1, ws1)
            if label == "-prune-sort weight":
                users = [int(r["userid"][len("person"):]) for r in rows5]
                if users != numpy_mean_top(t5, cfg5, cnt1, ws1):
                    fail(f"config 5 {label}: the printed users are not "
                         f"numpy's top 100 by the f32 mean score")
            elif counts != top_counts(cnt1):
                fail(f"config 5 {label}: the counts are not numpy's top-100")
            say(f"main path: CLI config 5 {label} on cuda (partition 1): "
                f"{len(counts)} printed groups == numpy; launches {ll}; "
                f"wall {wall:.3f}s")
            tally(launches, ll)

        # the sorted strategy's device prune: one user's rows of
        # partition 1 grouped by the second (past ENUM_RADIX_CAP)
        residency.CACHE.clear()
        rc, out, wall, ll = run_cli(
            ["query", "-dir", t5.flags.dir, *C5_USER_ARGV, "-json",
             "-device-batch", str(C5_BATCH), "-device", "cuda"])
        if rc != 0:
            fail(f"config 5 by the second: port CLI exited {rc}")
        for k, n in {"sorted_front": nb5, "segment_reduce": nb5,
                     "sorted_pack": nb5, "topk_rows": nb5,
                     "prune_gather": nb5, "enum_segments": 0,
                     "enum_pack": 0, "dense_scan": 0}.items():
            if ll[k] != n:
                fail(f"config 5 by the second: {k} launched {ll[k]}x, "
                     f"expected {n}: {ll}")
        sel = uid5 == C5_USER
        secs, inv = np.unique(c5_time[0][sel], return_inverse=True)
        hc = np.bincount(inv)
        hw = np.bincount(inv, weights=w5[sel].astype(np.float64)).astype(
            np.int64)
        rows_h = json.loads(out)
        # the device's winners by count, ties to the lower packed key (the
        # earlier second), in the printer's stable order by count
        top = np.lexsort((secs, -hc))[:100]
        got_h = [(int(r["time"]), r["Count"], r["weight"]) for r in rows_h]
        if got_h != [(int(secs[i]), int(hc[i]), hw[i] / hc[i]) for i in top]:
            fail(f"config 5 by the second: the printed seconds differ from "
                 f"numpy's 100 busiest (ties to the earlier second)")
        say(f"main path: CLI config 5, person{C5_USER}'s 100 busiest "
            f"seconds (partition 1, the sorted device prune) on cuda == "
            f"numpy, in order ({len(secs)} seconds, counts "
            f"{hc[top[0]]}..{hc[top[-1]]}); launches {ll}; wall "
            f"{wall:.3f}s")
        tally(launches, ll)

        # count distinct through the CLI: the device HLL (int and str
        # distinct columns), the distinct pairs of -op distinct (D = 2)
        # and config 5's partition 1 by userid, distinct weight (more
        # pairs than the packed section: the escalation)
        from sybil_tpu_torch.constants import GROUP_DELIMITER
        from sybil_tpu_torch.query.hll import HLL
        nb5_1 = c5[0][6]
        uid5_1, w5_1 = c5[0][2], c5[0][3]
        sort_steps = 3                    # K + D = 3 lanes: 3 sorts
        hll_int = numpy_hlls(up["host"], len(HOSTS),
                             np.arange(args.rows, dtype=np.int64), "int")
        hll_str = numpy_hlls(up["host"], len(HOSTS), up["status"], "str",
                             STATII)
        hll_pair = HLL()
        for h_, s_ in np.unique(np.stack([up["host"], up["status"]], 1),
                                axis=0).tolist():
            hll_pair.add((HOSTS[h_] + GROUP_DELIMITER + STATII[s_]
                          + GROUP_DELIMITER).encode())
        distinct_cli = (
            ("group by host, distinct index_int (device HLL, int)",
             table.flags.dir, "uptime", B,
             ["-group", "host", "-distinct", "index_int"],
             {"hll_registers": 1, "dense_scan": 1, "dense_pack": 1,
              "sorted_front": 0},
             lambda r: hll_int[HOSTS.index(r["host"])]),
            ("group by host, distinct status (device HLL, str)",
             table.flags.dir, "uptime", B,
             ["-group", "host", "-distinct", "status"],
             {"hll_registers": 1, "dense_scan": 1, "dense_pack": 1,
              "sorted_front": 0},
             lambda r: hll_str[HOSTS.index(r["host"])]),
            ("-group host,status -op distinct (pairs, D = 2)",
             table.flags.dir, "uptime", B,
             ["-group", "host,status", "-op", "distinct"],
             {"sorted_front": 1, "sort_permute": sort_steps - 1,
              "segment_reduce": 1, "sorted_pack": 1, "hll_registers": 0},
             lambda r: hll_pair),
            ("config 5 partition 1, group by userid, distinct weight "
             "(pair escalation)", t5_1.flags.dir, "sessions_zipf", C5_BATCH,
             ["-group", "userid", "-distinct", "weight"],
             {"sorted_front": nb5_1, "sort_permute": nb5_1,
              "segment_reduce": nb5_1, "sorted_pack": nb5_1,
              "hll_registers": 0, "enum_segments": 0},
             None))
        residency.CACHE.clear()
        for label, ddir, tname, nbq, argv, expect, want_of in distinct_cli:
            rc, out, wall, ll = run_cli(
                ["query", "-dir", ddir, "-table", tname, *argv, "-json",
                 "-device-batch", str(nbq), "-device", "cuda"])
            if rc != 0:
                fail(f"{label}: port CLI query exited {rc}")
            for k, n in expect.items():
                if ll[k] != n:
                    fail(f"{label}: {k} launched {ll[k]}x, expected {n}: "
                         f"{ll}")
            rows_d = json.loads(out)
            for r in rows_d:
                if want_of is None:
                    # the user's weights fed to a host HLL (int path)
                    u = int(r["userid"][len("person"):])
                    want_h = HLL()
                    for wv in np.unique(w5_1[uid5_1 == u]).tolist():
                        want_h.add(wv.to_bytes(8, "little", signed=True))
                else:
                    want_h = want_of(r)
                if r["Distinct"] != want_h.cardinality():
                    fail(f"{label}: row {r}: Distinct {r['Distinct']} vs "
                         f"numpy {want_h.cardinality()}")
            say(f"main path: CLI {label} on cuda: {len(rows_d)} printed "
                f"groups' Distinct == port HLLs fed the numpy values; "
                f"launches {ll}; wall {wall:.3f}s")
            tally(launches, ll)

        sets_main_path(card, stbl, sarr, launches)
        cache_rows = cache_phase(card, root, table, up, errs, launches, dev)

        # the mesh scan: MULTICHIP_r05.json's eight sharded shapes and
        # config 1 at -data-shards 8, one batch of each table
        def mspec(label, t, argv, expect, check=None, relaxed=None,
                  phases=False, max_groups=0):
            B = len(t.block_infos())
            f, p = cli_query(t, argv + ["-device-batch", str(B)])
            return dict(label=label, table=t, params=p,
                        flags=dataclasses.replace(f, max_groups=max_groups),
                        batches=1, expect=expect, check=check,
                        relaxed=relaxed, phases=phases)

        def check_groupby(label, want_g, col):
            def check(qr):
                for h, (cnt, s_) in want_g.items():
                    r = qr.results.get(h + "\t")
                    if cnt == 0:
                        continue
                    if r is None or r.count != cnt or \
                            r.hists[col].avg != s_ / cnt:
                        fail(f"mesh {label}: group {h} differs from numpy")
            return check

        def check_rollup(label, want_r):
            def check(qr):
                got_r = {(tb_, actions.index(r.group_key.rstrip("\t"))):
                         (r.count, r.hists["weight"].avg)
                         for tb_, rs in qr.time_results.items()
                         for r in rs.values()}
                if got_r != {k: (c, w / c) for k, (c, w) in want_r.items()}:
                    fail(f"mesh {label}: rows differ from numpy")
            return check

        cnt5, ws5 = want5[0]

        def relaxed5(qr_m, qr_u):
            # the device prune keeps the top 1000 rows of another table
            # order, so ties at its edge may pick other groups: the
            # printed counts and every kept group's count and mean hold
            top = [sorted((r.count for r in q.results.values()),
                          reverse=True) for q in (qr_m, qr_u)]
            if top[0] != top[1] or qr_m.cumulative.count != len(uid5_1):
                fail("mesh config 5: the top counts or the Cumulative row "
                     "differ from the unsharded query's")
            for r in qr_m.results.values():
                u = int(r.group_key.split("\t")[0][len("person"):])
                if r.count != cnt5[u] or \
                        r.hists["weight"].avg != ws5[u] / cnt5[u]:
                    fail(f"mesh config 5: user {u} differs from numpy")

        dense_x = {"dense_scan": MESH_D, "dense_pack": 1}
        sorted_x = {"sorted_front": MESH_D, "segment_reduce": MESH_D,
                    "sorted_pack": 1}
        sel1 = sarr["index_int"] % 3 == 0
        specs = [
            mspec("config 1", table, ["-group", "host", "-int", "ping",
                                      "-op", "avg"], dense_x,
                  check_groupby("config 1", want, "ping"), phases=True),
            mspec("config 3 -loghist", table, hist_argv["config 3 -loghist"],
                  dict(dense_x, dense_hist=MESH_D, outlier_compact=int(
                      bound["config 3 -loghist"].config.track_outliers))),
            mspec("config 4 (1 h)", ttable,
                  ["-group", "action", "-int", "weight", "-op", "avg",
                   "-time", "-time-bucket", str(C4_BUCKET), "-time-col",
                   "time"], dense_x, check_rollup("config 4", want4)),
            mspec("path 2", ttable, P2_ARGV, sorted_x,
                  check_rollup("path 2", want_p2), phases=True),
            mspec("distinct pairs host,status", table,
                  ["-group", "host,status", "-op", "distinct"], sorted_x),
            mspec("S1", stbl, S_ARGV["S1"], dict(dense_x, set_match=MESH_D),
                  check_groupby("S1", numpy_groupby(sarr["host"][sel1],
                                                    sarr["ping"][sel1]),
                                "ping")),
            mspec("S4a", stbl, S_ARGV["S4a"],
                  dict(dense_x, set_match=MESH_D)),
            mspec("S4b", stbl, S_ARGV["S4b"], sorted_x),
            # about 183,100 users: past the default 100,000-row table the
            # merged groups overflow it (refused, as the reference does),
            # so the mesh query holds 2^18 group rows
            mspec("config 5 partition 1", t5_1, C5_ARGV[2:],
                  dict(sorted_x, prune_gather=1), relaxed=relaxed5,
                  max_groups=1 << 18),
        ]
        residency.CACHE.clear()
        mesh_rows = mesh_phase(card, specs, errs, launches, dev)
        rc, out, wall, ll = run_cli(argv_q + ["-data-shards", str(MESH_D)])
        if rc != 0:
            fail(f"mesh config 1: port CLI query exited {rc}")
        got = {r["host"]: r for r in json.loads(out)}
        for h, (cnt, s_) in want.items():
            r = got[h]
            if r["Count"] != cnt or r["ping"] != s_ / cnt:
                fail(f"mesh config 1 CLI: group {h} differs from numpy")
        if ll["shuffle_partition"] != 1 or ll["shuffle_reduce"] != 1 \
                or ll["dense_scan"] != MESH_D:
            fail(f"mesh config 1 CLI: launches {ll}")
        tally(launches, ll)
        say(f"main path: CLI config 1 -data-shards {MESH_D} on cuda == numpy "
            f"group-by; launches {ll}; wall {wall:.3f}s")
        rs_rows = rowstore_phase(card, root, table, up, stbl, sarr, errs,
                                 launches, dev)
        missing = [k for k in COUNTED if launches[k] == 0]
        if missing:
            fail(f"kernels never launched on the main path: {missing}")
        if args.rows == DEFAULT_ROWS:
            off = {k: (launches[k], n) for k, n in MAIN_LAUNCHES.items()
                   if launches[k] != n}
            if off:
                fail(f"the main path's launches (got, want): "
                     f"{off}")
        say(f"main path launches over every query of phase 5: {launches}")
        # the host tools on copies of the uptime table: their queries
        # launch K1, K2 and K3 as config 1 does, counted apart
        tools_phase(card, root, table, up, dev)

        # cold/warm walls, no decode when warm, the batch pipeline
        qflags = dataclasses.replace(flags, device="cuda", device_batch=B)
        params1 = query_params(["host"], ["ping"])
        qr = timed_queries(card, "config 1", table, params1, qflags,
                           args.rows, B, {"dense_scan": 1, "dense_pack": 1,
                                          "dense_hist": 0,
                                          "outlier_compact": 0})
        for h, (cnt, s) in want.items():
            r = qr.results[h + "\t"]
            if r.count != cnt or r.hists["ping"].avg != s / cnt:
                fail(f"warm query group {h} differs from numpy")
        for label, (t, f, params) in hist_q.items():
            nb = len(t.block_infos())
            track = int(bound[label].config.track_outliers)
            timed_queries(card, label, t, params, dataclasses.replace(
                f, device="cuda", device_batch=nb), args.rows, nb,
                {"dense_scan": 1, "dense_hist": 1, "dense_pack": 1,
                 "outlier_compact": track})
        for tlabel, (t4, f4) in tables4.items():
            nb = len(t4.block_infos())
            qr4 = timed_queries(card, f"config 4 {tlabel}", t4, params4,
                                dataclasses.replace(f4, device="cuda",
                                                    device_batch=nb),
                                args.rows, nb,
                                {"dense_scan": 1, "dense_pack": 1,
                                 "dense_hist": 0, "outlier_compact": 0})
            got4 = {(tb_, actions.index(r.group_key.rstrip("\t"))):
                    (r.count, r.hists["weight"].avg)
                    for tb_, rs in qr4.time_results.items()
                    for r in rs.values()}
            if got4 != {k: (c, w / c) for k, (c, w) in want4.items()}:
                fail(f"config 4 {tlabel}: warm query differs from numpy")
        # this slice's paths through run_query
        flags_p1 = dataclasses.replace(flags, device="cuda", device_batch=B,
                                       tdigest=True)
        params_p1 = query_params(["host"], ["ping"], op="hist",
                                 htype="tdigest", filters=c3_filters)
        qr1 = timed_queries(card, "path 1 (config 3 -tdigest)", table,
                            params_p1, flags_p1, args.rows, B,
                            {"sorted_front": 1, "segment_reduce": 1,
                             "hist_prep": 1, "hist_pairs": 1,
                             "outlier_compact": track1,
                             "sorted_pack": 1, "dense_scan": 0})
        for i, h in enumerate(HOSTS):
            r = qr1.results[h + "\t"]
            hh = r.hists["ping"]
            if r.count != int(((up["host"] == i) & ok200).sum()) or \
                    hh.get_percentiles() != numpy_tdigest_percentiles(
                        want_pairs, h, agg_p1):
                fail(f"path 1: warm query host {h} differs from numpy")
        for tlabel, (t4, f4) in tables4.items():
            nb = len(t4.block_infos())
            qr2 = timed_queries(card, f"path 2 (config 4, {P2_BUCKET} s) "
                                f"{tlabel}", t4, params_p2,
                                dataclasses.replace(f4, device="cuda",
                                                    device_batch=nb),
                                args.rows, nb,
                                {"sorted_front": 1, "sort_permute": 1,
                                 "segment_reduce": 1, "sorted_pack": 1,
                                 "dense_scan": 0})
            got2 = {(tb_, actions.index(r.group_key.rstrip("\t"))):
                    (r.count, r.hists["weight"].avg)
                    for tb_, rs in qr2.time_results.items()
                    for r in rs.values()}
            if got2 != {k: (c, w / c) for k, (c, w) in want_p2.items()}:
                fail(f"path 2 {tlabel}: warm query differs from numpy")

        # config 5 per node through run_query, and `aggregate`
        for pi_, (t5, f5, uid5, w5, dirs5, cfg5, nb5) in enumerate(c5):
            timed_queries(card, f"config 5 node {pi_ + 1}", t5, params5,
                          dataclasses.replace(f5, device="cuda",
                                              device_batch=C5_BATCH),
                          len(uid5), 1, enum_launches(nb5))
        agg_walls = [run_aggregate(["-json"])[2] for _ in range(5)]
        say(f"[{card}] config 5 aggregate (two nodes' results, host only) "
            f"wall median of 5: {median(agg_walls) * 1e3:.3f} ms; walls "
            f"{[round(x * 1e3, 3) for x in agg_walls]}")

        # count distinct through run_query: walls and phases, K13 once a
        # batch, the device HLL's merged registers against the numpy-fed
        # HLLs byte for byte
        host_of = (lambda r: HOSTS.index(r.group_key.rstrip("\t")))
        sorted_expect = {"sorted_front": 1, "segment_reduce": 1,
                         "sorted_pack": 1, "hll_registers": 0,
                         "dense_scan": 0}
        for label, t, f, params, nbq, expect, hlls in (
                ("group by host, distinct index_int (device HLL)", table,
                 flags, query_params(["host"], [], distincts=["index_int"]),
                 B, {"hll_registers": 1, "dense_scan": 1, "dense_pack": 1},
                 hll_int),
                ("group by host, distinct status (device HLL)", table, flags,
                 query_params(["host"], [], distincts=["status"]), B,
                 {"hll_registers": 1, "dense_scan": 1, "dense_pack": 1},
                 hll_str),
                ("-op distinct host,status (pairs)", table, flags,
                 query_params([], [], distincts=["host", "status"]), B,
                 dict(sorted_expect, sort_permute=sort_steps - 1), None),
                ("config 5 partition 1, userid, distinct weight (pair "
                 "escalation)", t5_1, f5_1,
                 query_params(["userid"], [], distincts=["weight"]),
                 C5_BATCH, dict(sorted_expect, sort_permute=1), None)):
            qrd = timed_queries(card, f"distinct {label}", t, params,
                                dataclasses.replace(f, device="cuda",
                                                    device_batch=nbq),
                                args.rows if t is table else len(uid5_1),
                                nbq if t is table else 1, expect)
            if hlls is not None:
                n_ = hll_check(card, label, qrd, host_of, hlls, regs=True)
                say(f"distinct {label}: {n_} groups' merged registers == "
                    f"the numpy-fed HLLs' byte for byte")

        sets_timed(card, stbl, sarr, args.rows, len(stbl.block_infos()))

        # ---- phase 6: kernel times --------------------------------------
        sets_rows = sets_kernel_times(card, sets_ctx, dev)
        del sets_ctx
        ins, cs = k1_main["ping"]
        deltas, counts = ins[0], ins[1]
        Kk = ins[3].shape[1]
        live = int(counts.sum().item())
        k1_bytes = (live * deltas.element_size() + B * Kk * (4 + 8 + 4)
                    + B * 4 * 2 + R * 9)
        k1_ms = cuda_ms(lambda: decode_bucket2(*ins, C))
        k1_plain = cuda_ms(lambda: decode_bucket2_plain(*ins, C), iters=5)
        k1_ops = live * 20

        def k2_bytes(cfg, sub):
            # every referenced column read once (9 B a row), the gid
            # written when K4 follows, nrec, and the tables written
            Sc = scan.reduce_space(cfg)[1]
            L = 2 + 3 * len(cfg.aggs)
            H = len(scan.hist_aggs(cfg))
            B_, C_ = next(iter(sub.values()))[0].shape
            R_ = B_ * C_
            return (len(sub) * R_ * 9 + (R_ * 4 if H else 0) + B_ * 4
                    + Sc * (L + 2 * H) * 8 + 8)

        def k2_ops(cfg, R=R):
            # integer operations a row needs: block range test, each
            # filter's compare, each key's digit (test, subtract, clamp,
            # multiply-add), each aggregation's lanes (tests, adds, a
            # multiply) and min/max; a rollup's time quotient (an int32
            # division, about 20 instructions, or a 64-bit one, about 70)
            tq = (20 if cfg.time_i32 else 70) if cfg.time_col else 0
            return R * (6 + 3 * len(cfg.filters) + 8 * len(cfg.group_cols)
                        + 12 * len(cfg.aggs)
                        + 2 * len(scan.hist_aggs(cfg)) + tq + 2)

        # K2 on three shapes: config 1 (the PR-1 row), config 3, config 2
        c3 = bound["config 3"]
        c3l = bound["config 3 -loghist"]
        c2 = bound["config 2"]
        c3cols = {k: cols[k] for k in c3.needed_cols}
        c3fv = device_const(c3.filter_vals, dev)
        c2cols = {k: scols[k] for k in c2.needed_cols}
        c2fv = device_const(c2.filter_vals, dev)
        k2_times = {}
        for label, cfg, sub, fv, nr in (
                ("config 1", cfg1, sub1, None, nrec),
                ("config 3", c3.config, c3cols, c3fv, nrec),
                ("config 2", c2.config, c2cols, c2fv, snrec)):
            ms = cuda_ms(lambda: scan.dense_scan(cfg, sub, nr, fv))
            pms = cuda_ms(lambda: scan.dense_scan_plain(
                cfg, sub, nr, fv if fv is not None else
                torch.zeros(0, dtype=torch.int64, device=dev)), iters=5)
            k2_times[label] = (ms, pms, k2_bytes(cfg, sub), k2_ops(cfg))
            say(f"[{card}] dense_scan {label}: {ms:.4f} ms (bound "
                f"{k2_bytes(cfg, sub) / HBM_BYTES_PER_S * 1e3:.4f} ms bytes, "
                f"{k2_ops(cfg) / INT32_OPS_PER_S * 1e3:.4f} ms ops; plain "
                f"{pms:.4f} ms)")
        # one torch call over the config-1 rows: index_add_ of prebuilt
        # lanes into the same slots (host digit = dict id + 1, missing = 0)
        Sc1 = scan.reduce_space(cfg1)[1]
        L1 = 2 + 3 * len(cfg1.aggs)
        hv, hm = cols["host"]
        gid1 = torch.where(hm, hv + 1, 0).reshape(-1)
        lanes = torch.ones((R, L1), dtype=torch.int64, device=dev)
        k2_lib = cuda_ms(lambda: torch.zeros(
            (Sc1, L1), dtype=torch.int64, device=dev).index_add_(
                0, gid1, lanes), iters=5)
        # the same yardstick at config 3: K2's own gids, 5 lanes
        Sc3 = scan.reduce_space(c3.config)[1]
        L3 = 2 + 3 * len(c3.config.aggs)
        gid3 = scan.dense_scan(c3.config, c3cols, nrec, c3fv)["gid"].to(
            torch.int64)
        lanes = torch.ones((R, L3), dtype=torch.int64, device=dev)
        k2_lib3 = cuda_ms(lambda: torch.zeros(
            (Sc3, L3), dtype=torch.int64, device=dev).index_add_(
                0, gid3, lanes), iters=5)
        # and at config 2 (K2's own gids, 5 lanes)
        Sc2 = scan.reduce_space(c2.config)[1]
        L2 = 2 + 3 * len(c2.config.aggs)
        gid2 = scan.dense_scan(c2.config, c2cols, snrec, c2fv)["gid"].to(
            torch.int64)
        lanes = torch.ones((R, L2), dtype=torch.int64, device=dev)
        k2_lib2 = cuda_ms(lambda: torch.zeros(
            (Sc2, L2), dtype=torch.int64, device=dev).index_add_(
                0, gid2, lanes), iters=5)
        say(f"[{card}] dense_scan config 2: index_add_ over prebuilt lanes "
            f"{k2_lib2:.4f} ms")
        del lanes, gid1, gid3, gid2

        # K2 on config 4: each table, each form that applies
        k2_c4 = {}
        for tlabel, (cfg4, cols4, nrec4) in c4.items():
            R4 = int(nrec4.shape[0]) * C
            sub4 = cols4
            nbytes = k2_bytes(cfg4, sub4)
            pms = cuda_ms(lambda: scan.dense_scan_plain(
                cfg4, sub4, nrec4, None, (), C4_BUCKET), iters=3, warmup=1)
            # one torch call: index_add_ of prebuilt lanes by K2's gids
            gcfg = dataclasses.replace(cfg4, aggs=(dataclasses.replace(
                cfg4.aggs[0], num_values=1, bucket_size=1),))
            gid4 = scan.dense_scan(gcfg, sub4, nrec4, None, (), C4_BUCKET)[
                "gid"].to(torch.int64)
            Sc4 = scan.reduce_space(cfg4)[1]
            L4 = 2 + 3 * len(cfg4.aggs)
            lanes = torch.ones((R4, L4), dtype=torch.int64, device=dev)
            lib = cuda_ms(lambda: torch.zeros(
                (Sc4, L4), dtype=torch.int64, device=dev).index_add_(
                    0, gid4, lanes), iters=5)
            del lanes, gid4
            for form in ("windowed", "global"):
                def k2c4():
                    scan.dense_scan(cfg4, sub4, nrec4, None, (), C4_BUCKET,
                                    form=form)
                ms = cuda_ms(k2c4)
                dms = queued_ms(k2c4)
                nl, per = device_launches(k2c4)
                k2_c4[(tlabel, form)] = (ms, pms, nbytes, k2_ops(cfg4, R4),
                                         lib)
                say(f"[{card}] dense_scan config 4 {tlabel} {form}: "
                    f"device {dms:.4f} ms, {nl} device launches a call "
                    f"({per}); events {ms:.4f} ms (bound "
                    f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms bytes, "
                    f"{k2_ops(cfg4, R4) / INT32_OPS_PER_S * 1e3:.4f} ms "
                    f"ops; plain {pms:.4f} ms; index_add_ {lib:.4f} ms; "
                    f"window {cfg4.window}, band/chunk "
                    f"{scan.window_band(cfg4, C)})")

        # K6 on the bulk table's time column
        dl, bits6, bases6, src6 = k6_main["bulk"]
        B6 = int(src6.shape[0])
        k6_ms = cuda_ms(lambda: decode_value(dl, bits6, bases6, src6, C))
        k6_plain = cuda_ms(lambda: decode_value_plain(dl, bits6, bases6,
                                                      src6, C), iters=5)
        sh6 = torch.arange(8, dtype=torch.uint8, device=dev)

        def k6_lib():
            v = torch.cumsum(dl.to(torch.int64), dim=1) + bases6[:, None]
            m = ((bits6[:, :, None] >> sh6) & 1).reshape(B6, C) > 0
            return v, m
        k6_lib_ms = cuda_ms(k6_lib, iters=5)
        # deltas and bits read once, bases and the row map, values and
        # validity written
        k6_bytes = (dl.numel() * dl.element_size() + bits6.numel()
                    + B6 * 12 + B6 * C * 9)
        # per entry: widen, the scan's add, a shift and mask, two stores
        k6_ops = B6 * C * 6
        say(f"[{card}] decode_value bulk time ({dl.dtype} deltas): "
            f"{k6_ms:.4f} ms (plain {k6_plain:.4f} ms; cumsum + unpack "
            f"{k6_lib_ms:.4f} ms)")

        def k6_call():
            decode_value(dl, bits6, bases6, src6, C)
        say(f"[{card}] decode_value bulk time: device "
            f"{queued_ms(k6_call):.4f} ms; {profiled_kernels(k6_call)}")

        # K6's id mode on the sets table's index_str (a cold query keyed
        # or filtered on it decodes these containers), and K1's v1 mode
        # off the main path (no bench column needs it): one edge block,
        # 65,536 rows, repeated for as many rows as the main path's
        # batches
        from sybil_tpu_torch.ops.decode import (bucket_v1_batch,
                                                decode_bucket_v1,
                                                decode_bucket_v1_plain,
                                                decode_ids, decode_ids_plain,
                                                ids_batch)
        edge_of = {label: cs for label, cs, _ in b5}
        rows_idx = list(range(B6))
        src_all = torch.arange(B6, dtype=torch.int32, device=dev)
        ids_t, bits_t = (torch.from_numpy(a).to(dev) for a in ids_batch(
            ids_main, list(range(len(ids_main))), C))
        Bi = ids_t.shape[0]
        src_ids = torch.arange(Bi, dtype=torch.int32, device=dev)
        got = decode_ids(ids_t, bits_t, src_ids, C)
        want = decode_ids_plain(ids_t, bits_t, src_ids, C)
        check_equal(f"K6 ids {Bi} index_str blocks values", got[0], want[0],
                    errs["decode_value"])
        check_equal(f"K6 ids {Bi} index_str blocks valid", got[1], want[1],
                    errs["decode_value"])

        def kid_call():
            decode_ids(ids_t, bits_t, src_ids, C)
        kid_ms = cuda_ms(kid_call)
        kid_dev = queued_ms(kid_call)
        kid_plain = cuda_ms(lambda: decode_ids_plain(ids_t, bits_t, src_ids,
                                                     C), iters=5)
        kid_lib = cuda_ms(lambda: (
            ids_t.to(torch.int64),
            ((bits_t[:, :, None] >> sh6) & 1).reshape(Bi, C) > 0), iters=5)
        # ids and bits read once, the row map, values and validity written
        kid_bytes = Bi * C * 4 + bits_t.numel() + Bi * 4 + Bi * C * 9
        kid_ops = Bi * C * 4
        say(f"[{card}] decode_ids sets index_str ({Bi} str-id blocks): "
            f"device {kid_dev:.4f} ms, events {kid_ms:.4f} ms (bound "
            f"{kid_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; plain "
            f"{kid_plain:.4f} ms; widen + unpack {kid_lib:.4f} ms); "
            f"{profiled_kernels(kid_call)}")
        v1_ins = [torch.from_numpy(a).to(dev) for a in bucket_v1_batch(
            [edge_of["bucket v1"][0]] * B6, rows_idx)]
        got = decode_bucket_v1(*v1_ins, src_all, C)
        want = decode_bucket_v1_plain(*v1_ins, src_all, C)
        check_equal(f"K1 v1 {B6} blocks values", got[0], want[0],
                    errs["decode_bucket2"])
        check_equal(f"K1 v1 {B6} blocks valid", got[1], want[1],
                    errs["decode_bucket2"])
        v1_ms = cuda_ms(lambda: decode_bucket_v1(*v1_ins, src_all, C))
        v1_plain = cuda_ms(lambda: decode_bucket_v1_plain(*v1_ins, src_all,
                                                          C), iters=5)
        v1_live = int(v1_ins[1].sum().item())
        v1_K = v1_ins[3].shape[1]
        v1_bytes = (v1_live * v1_ins[0].element_size() + B6 * v1_K * (4 + 8)
                    + B6 * 4 * 3 + B6 * C * 9)
        v1_ops = v1_live * 20
        say(f"[{card}] decode_bucket_v1 {B6} v1 blocks ({v1_ins[0].dtype} "
            f"deltas, {v1_live} postings): {v1_ms:.4f} ms (plain "
            f"{v1_plain:.4f} ms)")

        # K4 on config 3 (and, in the text, -loghist and config 2)
        k4_times = {}
        for label, b, sub, fv, nr in (
                ("config 3", c3, c3cols, c3fv, nrec),
                ("config 3 -loghist", c3l, c3cols, c3fv, nrec),
                ("config 2", c2, c2cols, c2fv, snrec)):
            cfg = b.config
            gid = scan.dense_scan(cfg, sub, nr, fv)["gid"]
            ms = cuda_ms(lambda: scan.dense_hist(cfg, 0, sub, gid))
            pms = cuda_ms(lambda: scan.dense_hist_plain(cfg, 0, sub, gid),
                          iters=5)
            Sc = scan.reduce_space(cfg)[1]
            nv = cfg.aggs[0].num_values
            track = cfg.track_outliers
            # gid, value and validity read once; counts written; the
            # outlier mask and values written when tracked
            nbytes = R * (4 + 9) + Sc * nv * 8 + (R * 9 + 8 if track else 0)
            # per row: dead test, valid, discard bounds, subtract, divide,
            # range tests, clamp, index multiply-add, add; a multihist
            # tests each sub-range it passes
            ops = R * (12 + 4 * len(cfg.aggs[0].sub_edges))
            # one torch call: index_add_ of prebuilt weights into flat
            # gid * nv + bv ids (rows that do not count go to a spare id)
            hist0 = scan.dense_hist_plain(cfg, 0, sub, gid)["hist"]
            v0, m0 = sub[cfg.aggs[0].col]
            keep = (gid != Sc - 1) & m0.reshape(-1)
            bv, inr, _ = scan.hist_bucket_plain(cfg.aggs[0], v0.reshape(-1))
            keep &= inr & (v0.reshape(-1) >= cfg.aggs[0].discard_min) & \
                (v0.reshape(-1) <= cfg.aggs[0].discard_max)
            ids = torch.where(keep, gid.to(torch.int64) * nv + bv, Sc * nv)
            ones = torch.ones(R, dtype=torch.int64, device=dev)
            lib = cuda_ms(lambda: torch.zeros(
                Sc * nv + 1, dtype=torch.int64, device=dev).index_add_(
                    0, ids, ones), iters=5)
            got_lib = torch.zeros(Sc * nv + 1, dtype=torch.int64,
                                  device=dev).index_add_(0, ids, ones)
            if not torch.equal(got_lib[:-1].reshape(Sc, nv), hist0):
                fail(f"K4 {label}: the index_add_ yardstick computes "
                     f"another function")
            del ids, ones, keep, bv, inr
            k4_times[label] = (ms, pms, nbytes, ops, lib)
            say(f"[{card}] dense_hist {label}: {ms:.4f} ms (bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms bytes, "
                f"{ops / INT32_OPS_PER_S * 1e3:.4f} ms ops; plain "
                f"{pms:.4f} ms; index_add_ {lib:.4f} ms)")

        # K5 on config 3 -loghist (tracked sub-outliers)
        cfg5 = c3l.config
        if not cfg5.track_outliers:
            fail("config 3 -loghist does not track outliers")
        gid5 = scan.dense_scan(cfg5, c3cols, nrec, c3fv)["gid"]
        h5 = scan.dense_hist(cfg5, 0, c3cols, gid5)
        lay5 = scan.packed_layout(cfg5, R)
        main5 = torch.zeros((lay5["rows"], lay5["W"]), dtype=torch.int64,
                            device=dev)
        off5, kmax5 = lay5["out0"]
        mask5, val5 = h5["out_mask"], h5["out_val"]
        k5_ms = cuda_ms(lambda: scan.outlier_compact(
            cfg5, c3cols, mask5, val5, main5, off5), iters=50)
        k5_plain = cuda_ms(lambda: scan.outlier_compact_plain(
            cfg5, c3cols, mask5, val5, main5, off5), iters=5)
        hv5, hm5 = c3cols["host"]

        def k5_lib():
            idx = torch.nonzero(mask5).reshape(-1)[:kmax5]
            return torch.stack([torch.where(hm5.reshape(-1)[idx],
                                            hv5.reshape(-1)[idx], -1),
                                val5[idx]], dim=1)
        k5_lib_ms = cuda_ms(k5_lib, iters=20)
        n5 = int(h5["nout"].item())
        # the mask read once; the selected rows' key, validity and value
        # read; the section written
        k5_bytes = R + min(n5, kmax5) * (9 + 8) + kmax5 * lay5["W"] * 8
        k5_ops = R * 2 + kmax5 * lay5["W"]
        say(f"[{card}] outlier_compact config 3 -loghist: {k5_ms:.4f} ms "
            f"({n5} outliers, kmax {kmax5}; plain {k5_plain:.4f} ms; "
            f"nonzero+gather {k5_lib_ms:.4f} ms)")

        # K3 on config 3
        c3k2 = scan.dense_scan(c3.config, c3cols, nrec, c3fv)
        c3h = scan.dense_hist(c3.config, 0, c3cols, c3k2["gid"])
        lay3 = scan.packed_layout(c3.config, R)
        main3 = torch.empty((lay3["rows"], lay3["W"]), dtype=torch.int64,
                            device=dev)
        k3_args = (c3.config, c3k2, [c3h["hist"]], [c3h["nout"]], main3, R)
        k3_ms = cuda_ms(lambda: scan.dense_pack(*k3_args), iters=200)
        k3_plain = cuda_ms(lambda: scan.dense_pack_plain(*k3_args), iters=50)
        nv3 = c3.config.aggs[0].num_values
        k3_bytes = (Sc3 * (L3 + 2) * 8 + Sc3 * nv3 * 8 + 16
                    + lay3["rows"] * lay3["W"] * 8)
        say(f"[{card}] dense_pack config 3: {k3_ms:.4f} ms (plain "
            f"{k3_plain:.4f} ms, {k3_bytes} B)")
        # and on config 1, the PR-1 shape (no hist sections)
        k2c1 = scan.dense_scan(cfg1, sub1, nrec)
        lay1 = scan.packed_layout(cfg1, R)
        main1 = torch.empty((lay1["rows"], lay1["W"]), dtype=torch.int64,
                            device=dev)
        k3c1 = cuda_ms(lambda: scan.dense_pack(cfg1, k2c1, [], [], main1, R),
                       iters=200)
        say(f"[{card}] dense_pack config 1 (PR-1 shape): {k3c1:.4f} ms")

        # the sorted strategy's kernels at both paths' shapes (path 2 on
        # the bulk table), and the library sorts between them
        sorted_rows = []
        z64 = torch.zeros(0, dtype=torch.int64, device=dev)
        cfg_p2b, cols_p2b, nrec_p2b, _ = p2["bulk"]
        for plabel, cfg, sub, nr, fv, bits, tb in (
                ("path 1", cfg_p1, cols_p1, nrec, fv_p1, bits_p1, 1),
                (f"path 2 bulk", cfg_p2b, cols_p2b, nrec_p2b, z64, (),
                 P2_BUCKET)):
            Bn, Cn = next(iter(sub.values()))[0].shape
            Rn = Bn * Cn
            K = cfg.n_key_cols
            S = cfg.max_groups
            L = 2 + 3 * len(cfg.aggs)
            H = len(scan.hist_aggs(cfg))
            F = len(cfg.filters)
            packed = scan.sort_packed(cfg)
            tq = (20 if cfg.time_i32 else 70) if cfg.time_col else 0
            # K7: each key, filter and time column read once (9 B a row),
            # nrec and the constants; idxm and the packed key or the key
            # lanes written.  Per row: the block range test, each
            # filter's compare, each key's lane and digit, the time
            # quotient
            keyb = ((4 if scan.pack_sentinel(cfg)[1] == torch.int32 else 8)
                    if packed else 8 * K)
            k7_cols = {*cfg.group_cols, *(f.col for f in cfg.filters),
                       *([cfg.time_col] if cfg.time_col else [])}
            k7_bytes = (len(k7_cols) * Rn * 9 + Bn * 4 + F * 8
                        + Rn * (4 + keyb) + 8)
            k7_ops = Rn * (6 + 3 * F + 6 * K + tq)
            k7_ms = cuda_ms(lambda: scan.sorted_front(cfg, sub, nr, fv, bits,
                                                      tb))
            k7_plain = cuda_ms(lambda: scan.sorted_front_plain(
                cfg, sub, nr, fv, bits, tb), iters=5)
            sorted_rows.append(("sorted_front", plabel,
                                "sybil_tpu/ops/scan.py:1071", k7_ms, k7_plain,
                                k7_bytes, k7_ops, None))
            k7_call = functools.partial(scan.sorted_front, cfg, sub, nr, fv,
                                        bits, tb)
            say(f"[{card}] sorted_front {plabel}: device "
                f"{queued_ms(k7_call):.4f} ms, events {k7_ms:.4f} ms")
            LATE_PROFILES.append((f"sorted_front {plabel}", k7_call))
            front = scan.sorted_front(cfg, sub, nr, fv, bits, tb)
            # the sorts: one stable torch.sort (CUB radix sort) per key
            # lane, or of the packed key
            skey = front["key"] if packed else front["keys"][-1]
            sort_ms = cuda_ms(lambda: torch.sort(skey, stable=True))
            nsorts = 1 if packed else K
            order = scan.sort_rows(cfg, front)
            if not packed:
                keys0 = front["keys"][0]
                p_last = torch.sort(front["keys"][-1], stable=True)[1]
                sp_ms = cuda_ms(lambda: scan.sort_permute(None, p_last,
                                                          keys0))
                sp_plain = cuda_ms(lambda: scan.sort_permute_plain(
                    None, p_last, keys0), iters=5)
                sp_lib = cuda_ms(lambda: keys0[p_last], iters=5)
                # p read, the key lane gathered once, the gathered lane
                # written; an index load and a store a row
                sorted_rows.append(("sort_permute", plabel,
                                    "sybil_tpu/ops/scan.py:1119", sp_ms,
                                    sp_plain, Rn * 24, Rn * 4, sp_lib))
                sp_call = functools.partial(scan.sort_permute, None, p_last,
                                            keys0)
                say(f"[{card}] sort_permute {plabel}: device "
                    f"{queued_ms(sp_call):.4f} ms, events {sp_ms:.4f} ms, "
                    f"keys[p] {sp_lib:.4f} ms")
                LATE_PROFILES.append((f"sort_permute {plabel}", sp_call))
            k8 = scan.segment_reduce(cfg, sub, front, order, tb)
            k8_ms = cuda_ms(lambda: scan.segment_reduce(cfg, sub, front,
                                                        order, tb))
            k8_plain = cuda_ms(lambda: scan.segment_reduce_plain(
                cfg, sub, front, order, tb), iters=5)
            # one torch call: index_add_ of prebuilt lanes into [S+1, L]
            # by each sorted row's slot (row 5's yardstick)
            cg = torch.where((k8["sidxm"] < 0) & (k8["gid"] < S), k8["gid"],
                             S).to(torch.int64)
            lanes = torch.ones((Rn, L), dtype=torch.int64, device=dev)
            k8_lib = cuda_ms(lambda: torch.zeros(
                (S + 1, L), dtype=torch.int64, device=dev).index_add_(
                    0, cg, lanes), iters=5)
            del lanes, cg
            # p (and the running permutation) read, idxm gathered, the
            # packed key or the key lanes, the aggregation and weight
            # columns read once; kmat, sidxm, gid and the tables written.
            # Per row: the boundary test, a block scan, a 5-step warp-run
            # sum per lane, a min and a max per hist agg
            ncol = len(cfg.aggs) + (1 if cfg.weight_col else 0)
            k8_bytes = (Rn * 8 * (1 if order["base"] is None else 2) + Rn * 4
                        + (Rn * keyb if packed else Rn * 8 * K)
                        + ncol * Rn * 9 + Rn * (8 * K + 8)
                        + (S + 1) * L * 8 + S * K * 8 + S * H * 16)
            k8_ops = Rn * (12 + 12 * L + 12 * H)
            sorted_rows.append(("segment_reduce", plabel,
                                "sybil_tpu/ops/scan.py:1133", k8_ms,
                                k8_plain, k8_bytes, k8_ops, k8_lib))

            def k8_call():
                scan.segment_reduce(cfg, sub, front, order, tb)
            say(f"[{card}] segment_reduce {plabel}: device "
                f"{queued_ms(k8_call):.4f} ms, events {k8_ms:.4f} ms, "
                f"index_add_ {k8_lib:.4f} ms, bound "
                f"{k8_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
                f"{profiled_kernels(k8_call)}")
            layout = scan.packed_layout(cfg, Rn)
            mainx = torch.empty((layout["rows"], layout["W"]),
                                dtype=torch.int64, device=dev)
            pairs, nouts = [], []
            for ai in scan.hist_aggs(cfg):
                prep = scan.hist_prep(cfg, ai, sub, k8)
                agg = cfg.aggs[ai]
                kp_ms = cuda_ms(lambda: scan.hist_prep(cfg, ai, sub, k8))
                kp_plain = cuda_ms(lambda: scan.hist_prep_plain(
                    cfg, ai, sub, k8), iters=5)
                track = cfg.track_outliers
                wb = 8 if cfg.weight_col else 0
                keyb = prep["pairkey"].element_size()
                # every row: sidxm read, the key (and w, the outliers)
                # written; a matched row: gid read, the value, its valid
                # byte (and the weight's) gathered
                nm = int((k8["sidxm"] < 0).sum().item())
                kp_bytes = (Rn * (4 + keyb + wb + (9 if track else 0))
                            + nm * (4 + 9 + (9 if wb else 0))
                            + (8 if track else 0))
                kp_ops = Rn * (14 + 4 * len(agg.sub_edges))
                sorted_rows.append(("hist_prep", plabel,
                                    "sybil_tpu/ops/scan.py:1247", kp_ms,
                                    kp_plain, kp_bytes, kp_ops, None))
                pk = prep["pairkey"]
                pair_sort_ms = cuda_ms(lambda: torch.sort(pk, stable=True))
                spk, si2 = torch.sort(pk, stable=True)
                hpx = scan.hist_pairs(cfg, ai, spk, si2, prep["w"],
                                      k8["kmat"])
                kq_ms = cuda_ms(lambda: scan.hist_pairs(
                    cfg, ai, spk, si2, prep["w"], k8["kmat"]))
                kq_plain = cuda_ms(lambda: scan.hist_pairs_plain(
                    cfg, ai, spk, si2, prep["w"], k8["kmat"]), iters=5)
                # one torch call: index_add_ of the rows' weights into
                # their (group, bucket) segment
                pb = torch.ones(Rn, dtype=torch.bool, device=dev)
                pb[1:] = spk[1:] != spk[:-1]
                seg = torch.cumsum(pb.to(torch.int64), 0) - 1
                sent = (cfg.max_groups + 1) * agg.num_values
                below = spk < sent
                sw = (below.to(torch.int64) if prep["w"] is None
                      else prep["w"][si2])
                kq_lib = cuda_ms(lambda: torch.zeros(
                    Rn, dtype=torch.int64, device=dev).index_add_(0, seg, sw),
                    iters=5)
                # every row: the key read and the mask byte written; a row
                # below the sentinel with a weight column: si2 read, w
                # gathered; a set row and row R-1: si2 and kmat's row
                # read, hp_bv, hp_w and hp_keys written; npairs
                nset = int(hpx["npairs"][0].item()) + 1
                nbelow = int(below.sum().item()) if wb else 0
                kq_bytes = (Rn * (keyb + 1) + nbelow * 16
                            + nset * (8 + 8 * K + 16 + 8 * K) + 8)
                kq_ops = Rn * 12
                del pb, seg, sw, below
                sorted_rows.append(("hist_pairs", plabel,
                                    "sybil_tpu/ops/scan.py:1256", kq_ms,
                                    kq_plain, kq_bytes, kq_ops, kq_lib))
                say(f"[{card}] sorts, {plabel}: pair-key sort ({pk.dtype} "
                    f"[R], stable torch.sort) {pair_sort_ms:.4f} ms (bound "
                    f"{sort_bound_ms(Rn, keyb):.4f} ms)")
                pairs.append(hpx)
                nouts.append(prep["nout"])
                if track:
                    off, kmax = layout[f"out{ai}"]
                    mk, vk = prep["out_mask"], prep["out_val"]
                    kmat = k8["kmat"]
                    k5s_ms = cuda_ms(lambda: scan.outlier_compact(
                        cfg, sub, mk, vk, mainx, off, tb, kmat=kmat),
                        iters=50)
                    k5s_plain = cuda_ms(lambda: scan.outlier_compact_plain(
                        cfg, sub, mk, vk, mainx, off, tb, kmat=kmat), iters=5)
                    k5s_lib = cuda_ms(lambda: kmat[torch.nonzero(mk)
                                                   .reshape(-1)[:kmax]],
                                      iters=20)
                    n5s = int(prep["nout"].item())
                    sorted_rows.append((
                        "outlier_compact", f"{plabel} (kmat keys, {n5s} "
                        f"outliers)", "sybil_tpu/ops/scan.py:1802", k5s_ms,
                        k5s_plain, Rn + min(n5s, kmax) * (8 * K + 8)
                        + kmax * layout["W"] * 8, Rn * 2 + kmax * layout["W"],
                        k5s_lib))
            spill_t = front["spill"]
            kpk_ms = cuda_ms(lambda: scan.sorted_pack(cfg, k8, spill_t, pairs,
                                                      nouts, mainx, Rn),
                             iters=50)
            kpk_plain = cuda_ms(lambda: scan.sorted_pack_plain(
                cfg, k8, spill_t, pairs, nouts, mainx, Rn), iters=5)
            Wt = scan.table_width(cfg)
            Hcap = layout.get("Hcap", 0)
            kpk_bytes = ((S + 1) * L * 8 + S * K * 8 + S * H * 16 + 16
                         + S * Wt * 8 + scan.table_prefix(cfg) * layout["W"]
                         * 8 + H * (Rn + Hcap * (K + 3) * 8
                                    + Hcap * layout["W"] * 8))
            sorted_rows.append(("sorted_pack", plabel,
                                "sybil_tpu/ops/scan.py:1865", kpk_ms,
                                kpk_plain, kpk_bytes, S * Wt, None))
            say(f"[{card}] sorts, {plabel}: {nsorts} x stable torch.sort of "
                f"{skey.dtype} [{Rn}] {sort_ms:.4f} ms each "
                f"({nsorts * sort_ms:.4f} ms; bound "
                f"{sort_bound_ms(Rn, skey.element_size()):.4f} ms each); K7 "
                f"{k7_ms:.4f}, K8 {k8_ms:.4f}, pack {kpk_ms:.4f} ms")
            del front, order, k8, pairs, nouts, mainx

        # config 5's kernels at its first batch (partition 1), the sort
        # between them, and the sorted device prune at its [S] table
        cfg5, cols5, nr5, parts5 = c5_main
        R5 = nr5.numel() * cols5["userid"][0].shape[1]
        L5 = 2 + 3 * len(cfg5.aggs)
        P5 = scan.table_prefix(cfg5)
        Pk5 = min(P5, R5)
        skey5, p5, seg5 = parts5["skey"], parts5["p"], parts5["seg"]
        Smax5 = scan.enum_slots(cfg5, R5)
        ng5 = int(seg5["num_groups"].item())
        c5_rows = []
        k7e_ms = cuda_ms(lambda: scan.sorted_front(cfg5, cols5, nr5))
        k7e_plain = cuda_ms(lambda: scan.sorted_front_plain(cfg5, cols5, nr5),
                            iters=5)
        # the columns it reads (9 B a row each: the keys, the filters'
        # columns and the weight column where bound; config 5: userid
        # alone) and nrec; the 4 B key written, the spill and the totals.
        # Per row: the range test, the key's digit, the weight
        k7_cols = (len(cfg5.group_cols) + len({f.col for f in cfg5.filters})
                   + (1 if cfg5.weight_col else 0))
        c5_rows.append(("sorted_front", "config 5, enum form",
                        "sybil_tpu/ops/scan.py:1420", k7e_ms, k7e_plain,
                        R5 * (9 * k7_cols + 4) + nr5.numel() * 4 + 24,
                        R5 * 16, None))
        k7e_call = functools.partial(scan.sorted_front, cfg5, cols5, nr5)
        say(f"[{card}] sorted_front config 5, enum form: device "
            f"{queued_ms(k7e_call):.4f} ms, events {k7e_ms:.4f} ms")
        LATE_PROFILES.append(("sorted_front config 5, enum form", k7e_call))
        key5 = parts5["front"]["key"]
        sort5_ms = cuda_ms(lambda: torch.sort(key5, stable=True))
        say(f"[{card}] sorts, config 5: 1 x stable torch.sort of int32 "
            f"[{R5}] {sort5_ms:.4f} ms (bound {sort_bound_ms(R5, 4):.4f} "
            f"ms)")
        k11_ms = cuda_ms(lambda: scan.enum_segments(cfg5, cols5, skey5, p5))
        k11_plain = cuda_ms(lambda: scan.enum_segments_plain(
            cfg5, cols5, skey5, p5), iters=5)
        g11 = seg5["gid"].to(torch.int64)
        lanes = torch.ones((R5, L5), dtype=torch.int64, device=dev)
        k11_lib = cuda_ms(lambda: torch.zeros(
            (Smax5, L5), dtype=torch.int64, device=dev).index_add_(
                0, g11, lanes), iters=5)
        del lanes, g11
        # the sorted key (each row and its neighbour, counted once) and p
        # read; each aggregation's column and the weight column where
        # bound gathered at the sorted rows (9 B a row each; config 5:
        # weight alone); gid and the score written; the segment sums
        # written.  Per row: the boundary, a warp scan of its gid, a
        # 5-step warp scan a lane
        k11_cols = len(cfg5.aggs) + (1 if cfg5.weight_col else 0)
        c5_rows.append(("enum_segments", "config 5",
                        "sybil_tpu/ops/scan.py:1484", k11_ms, k11_plain,
                        R5 * (4 + 8 + 9 * k11_cols + 4
                              + seg5["score"].element_size())
                        + Smax5 * L5 * 8,
                        R5 * (12 + 12 * L5), k11_lib))
        sc5 = seg5["score"]
        k12_ms = cuda_ms(lambda: scan.topk_rows(sc5, Pk5))
        LATE_PROFILES.append(("topk_rows config 5",
                              lambda: scan.topk_rows(sc5, Pk5)))
        k12_plain = cuda_ms(lambda: scan.topk_rows_plain(sc5, Pk5), iters=5)
        k12_lib = cuda_ms(lambda: torch.topk(sc5, Pk5), iters=5)
        # the scores read once, k indices written; per row and pass over
        # the scores (two) a key transform, a prefix test and a digit
        c5_rows.append(("topk_rows", f"config 5, int64 [{R5}], k {Pk5}",
                        "sybil_tpu/ops/scan.py:1369", k12_ms, k12_plain,
                        R5 * 8 + Pk5 * 4, R5 * 4 * 2, k12_lib))
        cfg5w = dataclasses.replace(cfg5, prune_agg=0)
        sc5w = scan.enum_segments(cfg5w, cols5, skey5, p5)["score"]
        k12w_ms = cuda_ms(lambda: scan.topk_rows(sc5w, Pk5))
        k12w_plain = cuda_ms(lambda: scan.topk_rows_plain(sc5w, Pk5),
                             iters=5)
        k12w_lib = cuda_ms(lambda: torch.topk(sc5w, Pk5), iters=5)
        c5_rows.append(("topk_rows", f"config 5 -prune-sort weight, f32 "
                        f"[{R5}], k {Pk5}", "sybil_tpu/ops/scan.py:1369",
                        k12w_ms, k12w_plain, R5 * 4 + Pk5 * 4, R5 * 4 * 2,
                        k12w_lib))
        widx5 = parts5["widx"]
        lay5 = scan.packed_layout(cfg5, R5)
        mainx = torch.empty((lay5["rows"], lay5["W"]), dtype=torch.int64,
                            device=dev)
        spill5, tot5 = parts5["front"]["spill"], parts5["front"]["totals"]
        kep_ms = cuda_ms(lambda: scan.enum_pack(cfg5, skey5, seg5, widx5,
                                                spill5, tot5, mainx),
                         iters=50)
        kep_plain = cuda_ms(lambda: scan.enum_pack_plain(
            cfg5, skey5, seg5, widx5, spill5, tot5, mainx), iters=5)
        Wt5 = scan.table_width(cfg5)
        # per winner: its index, key, the next key, gid and L sums read;
        # the table row and the main row written
        c5_rows.append(("enum_pack", f"config 5 ({Pk5} winners)",
                        "sybil_tpu/ops/scan.py:1548", kep_ms,
                        kep_plain, Pk5 * (4 + 8 + 4 + L5 * 8)
                        + P5 * (Wt5 + lay5["W"]) * 8 + 40, P5 * Wt5, None))
        # the sorted device prune at config 5's batch (unpacked key)
        cfg_sp = dataclasses.replace(cfg5, sort_pack=())
        front_sp = scan.sorted_front(cfg_sp, cols5, nr5)
        order_sp = scan.sort_rows(cfg_sp, front_sp)
        k8_sp = scan.segment_reduce(cfg_sp, cols5, front_sp, order_sp)
        lay_sp = scan.packed_layout(cfg_sp, R5)
        main_sp = torch.empty((lay_sp["rows"], lay_sp["W"]),
                              dtype=torch.int64, device=dev)
        S_sp = cfg_sp.max_groups
        kpp_ms = cuda_ms(lambda: scan.sorted_pack(
            cfg_sp, k8_sp, front_sp["spill"], [], [], main_sp, R5), iters=50)
        kpp_plain = cuda_ms(lambda: scan.sorted_pack_plain(
            cfg_sp, k8_sp, front_sp["spill"], [], [], main_sp, R5), iters=5)
        k10_sp = scan.sorted_pack(cfg_sp, k8_sp, front_sp["spill"], [], [],
                                  main_sp, R5)
        Wt_sp = scan.table_width(cfg_sp)
        c5_rows.append(("sorted_pack", f"config 5 sorted device prune, "
                        f"table and score over {S_sp} slots",
                        "sybil_tpu/ops/scan.py:1886", kpp_ms, kpp_plain,
                        (S_sp + 1) * L5 * 8 + S_sp * 8 + 16 + S_sp * Wt_sp * 8
                        + S_sp * 8, S_sp * (Wt_sp + 8), None))
        sc_sp = k10_sp["score"]
        k12s_ms = cuda_ms(lambda: scan.topk_rows(sc_sp, P5))
        k12s_plain = cuda_ms(lambda: scan.topk_rows_plain(sc_sp, P5),
                             iters=5)
        k12s_lib = cuda_ms(lambda: torch.topk(sc_sp, P5), iters=5)
        c5_rows.append(("topk_rows", f"config 5 sorted device prune, int64 "
                        f"[{S_sp}], k {P5}", "sybil_tpu/ops/scan.py:1896",
                        k12s_ms, k12s_plain, S_sp * 8 + P5 * 4,
                        S_sp * 4 * 2, k12s_lib))
        pidx_sp = scan.topk_rows(sc_sp, P5)
        tbl_sp = k10_sp["table"]
        # the gather runs inside K12's launch (prune_topk_gather: the warp
        # that ranks a winner copies its row), so its row of the table is
        # that one launch, select and gather, timed in turns with K12
        # alone (alone, both, both, alone, twice; medians), by events and
        # queued
        def k12_alone():
            scan.topk_rows(sc_sp, P5)

        def k12_gather():
            scan.prune_topk_gather(cfg_sp, sc_sp, tbl_sp, main_sp)
        ev, dv = {k12_alone: [], k12_gather: []}, {k12_alone: [],
                                                   k12_gather: []}
        for fn in (k12_alone, k12_gather, k12_gather, k12_alone) * 2:
            ev[fn].append(cuda_ms(fn, iters=50))
            dv[fn].append(queued_ms(fn, iters=50))
        ev_both, ev_alone = median(ev[k12_gather]), median(ev[k12_alone])
        dv_both, dv_alone = median(dv[k12_gather]), median(dv[k12_alone])
        nl_alone, _ = recorded_launches(k12_alone)
        nl_both, per_both = recorded_launches(k12_gather)
        if nl_alone is None or nl_both != nl_alone:
            fail(f"the device prune's select and gather: {nl_both} device "
                 f"operations a call ({per_both}), not K12's {nl_alone}")
        kpg_plain = cuda_ms(lambda: scan.prune_gather_plain(
            cfg_sp, tbl_sp, pidx_sp, main_sp), iters=5)
        kpg_lib = cuda_ms(lambda: tbl_sp[pidx_sp.to(torch.int64)], iters=20)
        say(f"[{card}] the device prune's select and gather at config 5 "
            f"(one call, prune_topk_gather): events {ev_both:.4f} ms "
            f"(runs {', '.join(f'{v:.4f}' for v in ev[k12_gather])}), "
            f"device {dv_both:.4f} ms (runs "
            f"{', '.join(f'{v:.4f}' for v in dv[k12_gather])}), {nl_both} "
            f"device operations a call ({per_both}); K12 alone: events "
            f"{ev_alone:.4f} ms, device {dv_alone:.4f} ms, {nl_alone} device "
            f"operations; plain select and gather {k12s_plain:.4f} + "
            f"{kpg_plain:.4f} ms; torch.topk {k12s_lib:.4f} ms, table[pidx] "
            f"{kpg_lib:.4f} ms")
        # the scores read, pidx written, P rows of Wt words gathered and
        # written twice (main's prefix zero-padded to W, the pruned table)
        c5_rows.append(("prune_gather", f"config 5 sorted device prune, "
                        f"K12's select and the gather of {P5} rows in one "
                        f"launch (prune_topk_gather), int64 [{S_sp}]",
                        "sybil_tpu/ops/scan.py:1900", ev_both,
                        k12s_plain + kpg_plain,
                        S_sp * 8 + P5 * (4 + Wt_sp * 8 * 2 + lay_sp["W"] * 8),
                        S_sp * 4 * 2 + P5 * lay_sp["W"], None))
        say(f"[{card}] config 5 device work per batch: K7 {k7e_ms:.4f} + "
            f"sort {sort5_ms:.4f} + K11 {k11_ms:.4f} + K12 {k12_ms:.4f} + "
            f"K10 {kep_ms:.4f} = "
            f"{k7e_ms + sort5_ms + k11_ms + k12_ms + kep_ms:.4f} ms "
            f"({ng5} live groups of {R5} rows)")
        del front_sp, order_sp, k8_sp, k10_sp, main_sp, mainx

        # count distinct's kernels: K13 on both hash paths, K3's HLL
        # sections, and the pairs' K7, sorts, K8 and K10 at group by host,
        # distinct status, ping
        from sybil_tpu_torch.ops.scan import HLL_M
        distinct_rows = []
        for label, tag in (("group by host, distinct index_int", "int"),
                           ("group by host, distinct status", "str")):
            cfg, sub, bits, k2h = hll_ctx[label]
            gidh = k2h["gid"]
            slots, Sch, _ = scan.reduce_space(cfg)
            ms = cuda_ms(lambda: scan.hll_registers(cfg, sub, gidh, bits))
            pms = cuda_ms(lambda: scan.hll_registers_plain(cfg, sub, gidh,
                                                           bits),
                          iters=3, warmup=1)
            # one torch call: scatter_reduce_ amax on int32 registers from
            # a prebuilt flat index and rank
            v, m = sub[cfg.distinct_cols[0]]
            idx, rank = scan.hll_idx_rank_plain(scan._hll_hashes(
                cfg, v.reshape(-1), m.reshape(-1), bits))
            fidx = torch.where(gidh == Sch - 1, slots - 1, gidh).to(
                torch.int64) * HLL_M + idx
            lib = cuda_ms(lambda: torch.zeros(
                slots * HLL_M, dtype=torch.int32, device=dev).scatter_reduce_(
                    0, fidx, rank, "amax"), iters=5)
            got_lib = torch.zeros(slots * HLL_M, dtype=torch.int32,
                                  device=dev).scatter_reduce_(0, fidx, rank,
                                                              "amax")
            if not torch.equal(got_lib.to(torch.uint8).reshape(slots, HLL_M),
                               scan.hll_registers(cfg, sub, gidh, bits)):
                fail(f"K13 {label}: the scatter_reduce_ yardstick computes "
                     f"another function")
            del idx, rank, fidx, got_lib
            # gid and the distinct column read once, a str column's hash
            # array (nd int64 entries) read once, the planes written once.
            # Per row: the slot, the int hash (8 FNV rounds and the
            # finaliser: 64-bit multiplies of about 4 INT32 operations
            # each, about 80 in all) or the hash gather, the index and
            # rank, the register test
            nd = (bits[cfg.hll_hash_idx].shape[0] if cfg.hll_hash_idx >= 0
                  else 0)
            nbytes = R * (4 + 9) + nd * 8 + slots * HLL_M
            ops = R * (80 if tag == "int" else 20)
            distinct_rows.append(("hll_registers", f"{label} ({tag} hash)",
                                  "sybil_tpu/ops/scan.py:892", ms, pms,
                                  nbytes, ops, lib))
            say(f"[{card}] hll_registers {label}: {ms:.4f} ms (plain "
                f"{pms:.4f} ms; scatter_reduce_ amax {lib:.4f} ms)")
        cfg, sub, bits, k2h = hll_ctx["group by host, distinct index_int"]
        regs_h = scan.hll_registers(cfg, sub, k2h["gid"], bits)
        layh = scan.packed_layout(cfg, R)
        mainh = torch.empty((layh["rows"], layh["W"]), dtype=torch.int64,
                            device=dev)
        k3h_ms = cuda_ms(lambda: scan.dense_pack(cfg, k2h, [], [], mainh, R,
                                                 regs_h), iters=200)
        k3h_plain = cuda_ms(lambda: scan.dense_pack_plain(
            cfg, k2h, [], [], mainh, R, regs_h), iters=20)
        Sch = scan.reduce_space(cfg)[1]
        # the sums read, the shipped planes read, the buffer written
        k3h_bytes = (Sch * (2 + 3 * len(cfg.aggs)) * 8 + 8
                     + layh["Phll"] * HLL_M + layh["rows"] * layh["W"] * 8)
        distinct_rows.append(("dense_pack", f"HLL sections ({layh['Phll']} "
                              f"planes, group by host, distinct index_int)",
                              "sybil_tpu/ops/scan.py:1934", k3h_ms,
                              k3h_plain, k3h_bytes, 0, None))
        say(f"[{card}] dense_pack HLL sections: {k3h_ms:.4f} ms (plain "
            f"{k3h_plain:.4f} ms)")
        del regs_h, mainh
        plabel = "group by host, distinct status, ping"
        cfg, sub, nr, parts = pair_ctx[plabel]
        K, D = cfg.n_key_cols, len(cfg.distinct_cols)
        S, L = cfg.max_groups, 2 + 3 * len(cfg.aggs)
        k7d_ms = cuda_ms(lambda: scan.sorted_front(cfg, sub, nr))
        k7d_plain = cuda_ms(lambda: scan.sorted_front_plain(cfg, sub, nr),
                            iters=5)
        # each key and distinct column read once, nrec; idxm and the K + D
        # lanes written.  Per row: the range test, each lane's value
        distinct_rows.append(("sorted_front", f"{plabel}: K + D = {K + D} "
                              f"lanes", "sybil_tpu/ops/scan.py:435", k7d_ms,
                              k7d_plain, len(sub) * R * 9 + B * 4
                              + R * (4 + 8 * (K + D)), R * (6 + 6 * (K + D)),
                              None))
        k7d_call = functools.partial(scan.sorted_front, cfg, sub, nr)
        say(f"[{card}] sorted_front {plabel}: device "
            f"{queued_ms(k7d_call):.4f} ms, events {k7d_ms:.4f} ms")
        LATE_PROFILES.append((f"sorted_front {plabel}", k7d_call))
        # sort_rows' order, as the engine runs it (lane 0 from the last
        # sort's values)
        frontd = parts["front"]
        orderd = scan.sort_rows(cfg, frontd)
        for k in range(K + D - 1, -1, -1):
            lane = frontd["keys"][k]
            say(f"[{card}] sorts, {plabel}: lane {k} stable torch.sort of "
                f"int64 [{R}] {cuda_ms(lambda: torch.sort(lane, stable=True)):.4f}"
                f" ms (bound {sort_bound_ms(R, 8):.4f} ms)")
        k8d_ms = cuda_ms(lambda: scan.segment_reduce(cfg, sub, frontd,
                                                     orderd))
        k8d_plain = cuda_ms(lambda: scan.segment_reduce_plain(
            cfg, sub, frontd, orderd), iters=5)
        k8d = parts["k8"]
        cg = torch.where((k8d["sidxm"] < 0) & (k8d["gid"] < S), k8d["gid"],
                         S).to(torch.int64)
        lanes = torch.ones((R, L), dtype=torch.int64, device=dev)
        k8d_lib = cuda_ms(lambda: torch.zeros(
            (S + 1, L), dtype=torch.int64, device=dev).index_add_(
                0, cg, lanes), iters=5)
        del lanes, cg
        # p and base read, idxm and the K + D lanes gathered, kmat, dmat,
        # the pair mask, sidxm and gid written, the tables written.  Per
        # row: the boundary tests over K + D lanes, a block scan, the
        # warp-run sums of the two lanes
        k8d_bytes = (R * 16 + R * 4 + R * 8 * (K + D) + R * (8 * (K + D) + 9)
                     + (S + 1) * L * 8 + S * K * 8)
        distinct_rows.append(("segment_reduce", f"{plabel}: the pair mask",
                              "sybil_tpu/ops/scan.py:1191", k8d_ms,
                              k8d_plain, k8d_bytes,
                              R * (12 + 4 * (K + D) + 12 * L), k8d_lib))

        def k8d_call():
            scan.segment_reduce(cfg, sub, frontd, orderd)
        say(f"[{card}] segment_reduce {plabel}: device "
            f"{queued_ms(k8d_call):.4f} ms, events {k8d_ms:.4f} ms, "
            f"index_add_ {k8d_lib:.4f} ms, bound "
            f"{k8d_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
            f"{profiled_kernels(k8d_call)}")
        layd = scan.packed_layout(cfg, R)
        maind = torch.empty((layd["rows"], layd["W"]), dtype=torch.int64,
                            device=dev)
        spd = frontd["spill"]
        k10d_ms = cuda_ms(lambda: scan.sorted_pack(cfg, k8d, spd, [], [],
                                                   maind, R), iters=50)
        k10d_plain = cuda_ms(lambda: scan.sorted_pack_plain(
            cfg, k8d, spd, [], [], maind, R), iters=5)
        kmaxd = layd["kmax_pairs"]
        Wtd = scan.table_width(cfg)
        k10d_bytes = ((S + 1) * L * 8 + S * K * 8 + 16 + S * Wtd * 8
                      + scan.table_prefix(cfg) * layd["W"] * 8 + R
                      + kmaxd * ((K + D) * 8 + layd["W"] * 8))
        distinct_rows.append(("sorted_pack", f"{plabel}: the pair section "
                              f"({kmaxd} rows)", "sybil_tpu/ops/scan.py:1925",
                              k10d_ms, k10d_plain, k10d_bytes, S * Wtd + R,
                              None))
        say(f"[{card}] {plabel}: K7 {k7d_ms:.4f}, K8 {k8d_ms:.4f}, K10 "
            f"{k10d_ms:.4f} ms")
        del maind
        # K5 over the sorted keys (kmat) at path 1's shape, outlier
        # tracking forced on (the bench data has no live outlier rows)
        cfg_t = dataclasses.replace(cfg_p1, track_outliers=True)
        front_t = scan.sorted_front(cfg_t, cols_p1, nrec, fv_p1, bits_p1)
        k8_t = scan.segment_reduce(cfg_t, cols_p1, front_t,
                                   scan.sort_rows(cfg_t, front_t))
        prep_t = scan.hist_prep(cfg_t, 0, cols_p1, k8_t)
        lay_t = scan.packed_layout(cfg_t, R)
        main_t = torch.empty((lay_t["rows"], lay_t["W"]), dtype=torch.int64,
                             device=dev)
        off_t, kmax_t = lay_t["out0"]
        mk_t, vk_t, kmat_t = prep_t["out_mask"], prep_t["out_val"], \
            k8_t["kmat"]
        k5k_ms = cuda_ms(lambda: scan.outlier_compact(
            cfg_t, cols_p1, mk_t, vk_t, main_t, off_t, 1, kmat=kmat_t),
            iters=50)
        k5k_plain = cuda_ms(lambda: scan.outlier_compact_plain(
            cfg_t, cols_p1, mk_t, vk_t, main_t, off_t, 1, kmat=kmat_t),
            iters=5)
        k5k_lib = cuda_ms(lambda: kmat_t[torch.nonzero(mk_t).reshape(-1)
                                         [:kmax_t]], iters=20)
        n5k = int(prep_t["nout"].item())
        Kt = cfg_t.n_key_cols
        distinct_rows.append((
            "outlier_compact", f"path 1 over kmat ({n5k} outliers)",
            "sybil_tpu/ops/scan.py:1802", k5k_ms, k5k_plain,
            R + min(n5k, kmax_t) * (8 * Kt + 8) + kmax_t * lay_t["W"] * 8,
            R * 2 + kmax_t * lay_t["W"], k5k_lib))
        del front_t, k8_t, prep_t, main_t

        k2c3 = k2_times["config 3"]
        k4c3 = k4_times["config 3"]
        rows_out = []
        c4rows = tuple(
            (f"dense_scan", f"config 4, {tl} table, {form} form",
             "sybil_tpu/ops/scan.py:704", *k2_c4[(tl, form)])
            for tl, form in (("time-sorted", "windowed"),
                             ("bulk", "windowed"), ("bulk", "global"),
                             ("arrival order", "windowed"),
                             ("arrival order", "global")))
        for name, what, rep, ms, pms, nbytes, ops, lib in (
                ("decode_bucket2", "config 1 ping column",
                 "sybil_tpu/ops/decode.py:86", k1_ms, k1_plain, k1_bytes,
                 k1_ops, None),
                ("decode_bucket2", f"v1 mode, {B6} edge blocks, off the main "
                 "path", "sybil_tpu/ops/decode.py:61", v1_ms, v1_plain,
                 v1_bytes, v1_ops, None),
                ("decode_value", "config 4 time column, bulk table",
                 "sybil_tpu/ops/decode.py:40", k6_ms, k6_plain, k6_bytes,
                 k6_ops, k6_lib_ms),
                ("decode_value", f"id mode, the sets table's index_str "
                 f"({Bi} str-id blocks)", "sybil_tpu/ops/decode.py:51",
                 kid_ms, kid_plain, kid_bytes, kid_ops, kid_lib),
                ("dense_scan", "config 3", "sybil_tpu/ops/scan.py:629",
                 k2c3[0], k2c3[1], k2c3[2], k2c3[3], k2_lib3),
                *c4rows,
                ("dense_hist", "config 3", "sybil_tpu/ops/scan.py:497",
                 k4c3[0], k4c3[1], k4c3[2], k4c3[3], k4c3[4]),
                ("outlier_compact", "config 3 -loghist",
                 "sybil_tpu/ops/scan.py:1802", k5_ms, k5_plain, k5_bytes,
                 k5_ops, k5_lib_ms),
                ("dense_pack", "config 3", "sybil_tpu/ops/scan.py:1825",
                 k3_ms, k3_plain, k3_bytes, 0, None),
                *sorted_rows, *c5_rows, *distinct_rows, *sets_rows,
                *cache_rows, *mesh_rows, *rs_rows):
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT32_OPS_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            rows_out.append({
                "name": name, "shape": what, "route": "cuda",
                "source": "sybil_tpu_torch/csrc/"
                + ENTRY_SOURCES.get(name, name) + ".cu",
                "replaces": rep, "launches": launches[name],
                "max_abs_err": max(errs[name]) if errs[name] else 0.0,
                "ms": ms, "plain_ms": pms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib})
            say(f"[{card}] {name} ({what}): {ms:.4f} ms (bound "
                f"{bound_ms:.4f} ms by "
                f"{rows_out[-1]['bound_by']}: {nbytes} B, {ops} int ops; "
                f"plain {pms:.4f} ms"
                + (f"; library {lib:.4f} ms" if lib is not None else "")
                + ")")
        for label, fn in LATE_PROFILES:
            say(f"[{card}] {label}: {profiled_kernels(fn)}")
        del LATE_PROFILES[:]
        late_op_checks(card)
        say(f"[{card}] torch.profiler: {PROFILE_MISSES['calls']} profiled "
            f"calls recorded no device event in their first 8 profiles; "
            f"padded profiles ({PROFILE_PAD_S * 1e3:.0f} ms either side) "
            f"recovered {PROFILE_MISSES['recovered']} of them")
        say(f"[{card}] dense_scan config 1 (PR-1 shape): "
            f"{k2_times['config 1'][0]:.4f} ms; index_add_ over prebuilt "
            f"lanes {k2_lib:.4f} ms")
        say(json.dumps({"kernels": rows_out}))
    finally:
        if sets_proc is not None and sets_proc.poll() is None:
            sets_proc.kill()
            sets_proc.wait()
        shutil.rmtree(root, ignore_errors=True)

    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
