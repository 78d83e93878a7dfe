"""Per-block-group query result cache.

The reference caches per-block partial results keyed by
md5(params minus filters trivially true for the whole block), stored
inside each block dir, and only for FULL (immutable) blocks
(src/lib/query_cache.go:69-131,174-242, only-full-blocks rule :185) —
so a steady stream of ingested blocks never invalidates the cached work
of the old immutable ones, and time-sliding dashboard queries still hit
on interior blocks.

This engine scans batches of blocks per device dispatch, so the cache
unit is a STABLE GROUP of 16 consecutive full blocks in name order (16
is the reference's combine granularity, CHUNKS_BEFORE_GC table_io.go:17).
Block names are monotonic (creation-time-prefixed), so newly digested
blocks always append new groups and never disturb existing ones; partial
blocks and the trailing <16 remainder are scanned uncached per query.
Cached entries hold the accumulator's raw partial rows (counts, agg
sums, hist bucket arrays, HLL registers) in the SYB1 binary container
(codec.py) under db/T/cache/q_<md5>.syb: simple shapes write their
parked COLUMNAR batches as raw little-endian arrays (and load straight
back into the columnar fast lane — no per-row dict churn on hit or
write); shapes with histogram / t-digest / HLL / outlier state write a
compact JSON row list whose big arrays (bucket matrices, register
planes, centroids) are hoisted into raw binary sections.  (Rounds 1-4
used gzipped base64-JSON, which alone cost more than an uncached scan
on register-heavy shapes.)

The time-sliding trick is preserved per group: filters trivially true
over every block in the group are dropped from that group's key
(GetCacheRelevantFilters semantics, query_cache.go:69-131).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .. import constants
from ..constants import CHUNK_SIZE
from ..debug import debug
from ..table import Table
from .spec import QueryParams

GROUP_SIZE = 16  # blocks per cache unit (table_io.go:17)

# per-process counters (observability + tests)
HITS = 0
MISSES = 0


def relevant_filters(params: QueryParams, table: Table,
                     block_infos: dict) -> list:
    """Filters that could exclude rows in the given blocks; int filters
    trivially true over every block's [min,max] are dropped from the key
    (query_cache.go:69-131)."""
    keep = []
    schema = table.schema
    for f in params.filters:
        if f.kind != "int" or f.op not in ("gt", "lt"):
            keep.append(f)
            continue
        v = int(f.value)
        trivial = True
        for info in block_infos.values():
            kid = schema.key_table.get(f.col)
            ii = info.int_info.get(kid) if kid is not None else None
            if ii is None:
                trivial = False
                break
            if f.op == "gt" and not (ii.min > v):
                trivial = False
                break
            if f.op == "lt" and not (ii.max < v):
                trivial = False
                break
        if not trivial:
            keep.append(f)
    return keep


def stable_groups(block_dirs: list[str], infos: dict):
    """-> (groups, rest): complete 16-block groups of FULL blocks in name
    order (cacheable), plus every other scanned dir (partial blocks and
    the trailing remainder — always re-scanned, query_cache.go:185)."""
    full = sorted(d for d in block_dirs
                  if d in infos and infos[d].num_records >= CHUNK_SIZE)
    fullset = set(full)
    groups = [full[i: i + GROUP_SIZE]
              for i in range(0, len(full) - GROUP_SIZE + 1, GROUP_SIZE)]
    grouped = {d for g in groups for d in g}
    rest = [d for d in block_dirs if d not in grouped]
    return groups, rest


def group_cache_key(params: QueryParams, table: Table, gdirs: list[str],
                    infos: dict) -> str:
    import dataclasses
    ginfos = {d: infos[d] for d in gdirs if d in infos}
    pruned = dataclasses.replace(
        params,
        filters=tuple(relevant_filters(params, table, ginfos)),
        # result-shaping params don't affect the partial rows
        order_by="", order_asc=False, prune_by="", limit=0,
        num_distinct=-1)
    sig = []
    for bdir in gdirs:
        try:
            mtime = os.stat(os.path.join(bdir, "info.json")).st_mtime_ns
        except FileNotFoundError:
            mtime = -1
        sig.append((os.path.basename(bdir), mtime))
    payload = pruned.cache_key() + json.dumps(sig)
    return hashlib.md5(payload.encode()).hexdigest()


def _cache_path(table: Table, key: str) -> str:
    return os.path.join(table.dir, constants.CACHE_DIR, f"q_{key}.syb")


def _fast_sections(acc):
    """Columnar form: the accumulator's parked batches as raw arrays.
    Eligible exactly when the scan's columnar fast lane was (no hist /
    distinct / outlier / t-digest state, absorb_packed gate)."""
    batches = acc.np_batches
    ak = np.concatenate([b[0] for b in batches])
    sections = {
        "fk": np.ascontiguousarray(ak, dtype=np.int64),
        "fc": np.concatenate([b[1] for b in batches]).astype(np.int64),
        "fs": np.concatenate([b[2] for b in batches]).astype(np.int64),
    }
    n_aggs = len(batches[0][3])
    for ai in range(n_aggs):
        for fi, fname in enumerate(("ex", "cnt", "wv", "mn", "mx")):
            col = np.concatenate(
                [np.asarray(b[3][ai][fi]) for b in batches])
            dt = np.int8 if fname == "ex" else np.int64
            sections[f"a{ai}_{fname}"] = col.astype(dt)
    return {"fast": True, "n_aggs": n_aggs}, sections


def _row_sections(acc):
    """Row form: JSON rows with the big arrays (hist bucket rows, HLL
    register planes, t-digest centroids) hoisted into binary sections,
    referenced by index."""
    acc._materialize()
    rows = []
    hists: list[np.ndarray] = []
    hlls: list[np.ndarray] = []
    td_means: list[np.ndarray] = []
    td_weights: list[np.ndarray] = []
    for kt, row in acc.rows.items():
        aggs = []
        for cur in row["aggs"]:
            if cur is None:
                aggs.append(None)
                continue
            a = {"c": cur["count"], "w": cur["wv"],
                 "mn": cur["min"], "mx": cur["max"],
                 "o": [int(x) for x in cur["outliers"]]}
            if cur["hist"] is not None:
                a["hi"] = len(hists)
                hists.append(np.asarray(cur["hist"], dtype=np.int64))
            if cur.get("td") is not None:
                means, weights = cur["td"].centroids()
                a["ti"] = len(td_means)
                td_means.append(np.asarray(means, dtype=np.float64))
                td_weights.append(np.asarray(weights, dtype=np.float64))
            aggs.append(a)
        d = None
        if row["distinct"] is not None:
            d = len(hlls)
            hlls.append(np.asarray(row["distinct"].registers,
                                   dtype=np.uint8))
        rows.append([list(kt), row["count"], row["samples"], aggs, d])
    sections = {}

    def ragged(name, parts):
        if not parts:
            return
        sections[name] = np.concatenate(parts)
        sections[name + "_off"] = np.cumsum(
            [0] + [len(p) for p in parts]).astype(np.int64)

    ragged("hist", hists)
    ragged("tdm", td_means)
    ragged("tdw", td_weights)
    if hlls:
        # SPARSE register planes: a group that saw d distinct values
        # touches at most d of the 2^14 registers, so a time-bucketed
        # rollup over a small-cardinality column stores ~20 (idx, rank)
        # pairs per row instead of a dense 16KB plane (dense planes
        # made the cache entry ~1000x the partial it encodes)
        idxs, vals = [], []
        for regs in hlls:
            nz = np.nonzero(regs)[0]
            idxs.append(nz.astype(np.int32))
            vals.append(regs[nz])
        ragged("hlli", idxs)
        ragged("hllv", vals)
        sections["hll_m"] = np.asarray([hlls[0].shape[0]], dtype=np.int64)
    return {"fast": False, "rows": rows}, sections


def _acc_from_container(c, bound):
    from .engine import _Accumulator
    from .hll import HLL
    meta = c.meta
    acc = _Accumulator(bound)
    acc.matched_count = int(meta.get("matched", 0))
    acc.batches = int(meta.get("batches", 1))
    if meta.get("fast"):
        ak = c.read("fk")
        aggs = []
        for ai in range(int(meta.get("n_aggs", 0))):
            aggs.append(tuple(
                c.read(f"a{ai}_{f}") for f in
                ("ex", "cnt", "wv", "mn", "mx")))
        acc.np_batches.append((ak, c.read("fc"), c.read("fs"), aggs))
        return acc

    def ragged(name, i):
        off = c.read(name + "_off")
        return c.read(name)[off[i]: off[i + 1]]

    for kt_l, count, samples, aggs_w, di in meta["rows"]:
        aggs = []
        for cur in aggs_w:
            if cur is None:
                aggs.append(None)
                continue
            a = {"count": cur["c"], "wv": cur["w"],
                 "min": cur["mn"], "max": cur["mx"],
                 "hist": (np.asarray(ragged("hist", cur["hi"]),
                                     dtype=np.int64)
                          if "hi" in cur else None),
                 "outliers": list(cur["o"])}
            if "ti" in cur:
                from .hist import TDigest
                td = TDigest()
                td.add_many(ragged("tdm", cur["ti"]).tolist(),
                            ragged("tdw", cur["ti"]).tolist())
                a["td"] = td
            aggs.append(a)
        distinct = None
        if di is not None:
            distinct = HLL()
            m = int(c.read("hll_m")[0])
            regs = np.zeros(m, dtype=np.uint8)
            regs[ragged("hlli", di)] = ragged("hllv", di)
            distinct.registers = regs
        acc.rows[tuple(kt_l)] = {"count": count, "samples": samples,
                                 "aggs": aggs, "distinct": distinct}
    return acc


def load_group_rows(table: Table, key: str, bound):
    global HITS, MISSES
    from ..codec import read_container
    path = _cache_path(table, key)
    try:
        c = read_container(path)
        if c.meta.get("cv") != 2:
            MISSES += 1
            return None
        HITS += 1
        return _acc_from_container(c, bound)
    except (OSError, ValueError, KeyError, IndexError):
        MISSES += 1
        return None


def save_group_rows(table: Table, key: str, acc) -> None:
    from ..codec import write_container
    os.makedirs(os.path.join(table.dir, constants.CACHE_DIR), exist_ok=True)
    path = _cache_path(table, key)
    try:
        if acc.np_batches and not acc.rows:
            meta, sections = _fast_sections(acc)
        else:
            meta, sections = _row_sections(acc)
        meta.update({"cv": 2, "matched": acc.matched_count,
                     "batches": acc.batches})
        write_container(path, meta, sections)
        debug("query cache write", key)
    except OSError as e:
        debug("query cache write failed", e)
