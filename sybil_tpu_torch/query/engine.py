"""Query engine orchestrator.

Port of sybil_tpu/query/engine.py.  The plan:

  bind     resolve columns/types, build the static ScanConfig
  scan     batches of blocks -> [B, CHUNK] device tensors (decoded by
           K1 and K6 and kept resident, ops/residency.py), and each set
           column's batch CSR (kept resident too) -> one scan_packed
           call per batch (K14 per set filter; then dense: K2, K4 + K5
           per histogram, K3; sorted:
           K7, the sorts, K8, K9 + K5 per histogram, K10, and K12 under
           the device prune; enumerated: K7, the sort, K11, K12, K10;
           ops/scan.py)
           -> one packed buffer copied to pinned host memory without
           blocking; a dense key bound that spills restarts the scan on
           the unpacked sorted strategy; a samples query reads its
           matched rows back from the blocks
  rowstore with -read-log, the undigested WAL replayed into pseudo-blocks
           on the device, each one scan_packed call (_scan_rowstore)
  merge    the host merges the (small) per-batch group tables, bucket
           matrices, sparse hist pairs, outlier rows, and a count
           distinct's HLL register planes (the dense strategy's device
           HLL, K13) or (group, distinct) pairs (the sorted strategy)
  finish   translate group keys to display strings (aggregate.go:284-324),
           sort (aggregate.go:469-525), build the Cumulative row

With -data-shards D the scan runs over a mesh of D data shards
(parallel/mesh.py): each batch's blocks split into D contiguous shards,
each scanned up to its group table, and the hash-partitioned shuffle
(K15, the exchange, K16) merges the tables before one pack; with
-dist-coordinator/-dist-pid/-dist-nproc N processes (one a card) join
one torch.distributed group, each loading and scanning its span of
every batch (parallel/multihost.py), and process 0 prints.

With -cache-queries each stable group of 16 full blocks answers from its
cache file (query/cache.py) or is scanned and written; the missed groups
share dispatches through the cache-group key, which the kernels make
from each row's block position (_cached_scan, _scan_cache_vgroups).

Block skipping replicates ShouldLoadBlockFromDir's min/max pruning
(table_block_io.go:110-182).
"""

from __future__ import annotations

import re

import numpy as np

from .. import blocks as blockio
from ..config import Flags
from ..constants import (CHUNK_SIZE, GROUP_DELIMITER, INT_VAL,
                         INTERNAL_RESULT_LIMIT, MISSING_VALUE, NO_VAL,
                         SET_VAL, SORT_COUNT, STR_VAL)
from ..debug import debug, error, warn
from ..table import Table
from .hist import BasicHist, MultiHist, basic_bucket_layout, multi_hist_layout
from .hll import HLL
from .spec import QueryParams, Result

MISSING_I64 = -1  # == MaxUint64 in two's complement


class QueryResults:
    """Query output.  `time_results` materializes LAZILY: a rollup's
    per-bucket Result objects (thousands of rows — the reference builds
    them per record batch, aggregate.go:146-169) are only exploded from
    the columnar finish tables when a consumer (printer, wire format,
    aggregator) actually reads them; run_query itself stays columnar."""

    def __init__(self):
        self.results: dict[str, Result] = {}
        self._time_results: dict[int, dict[str, Result]] = {}
        self._time_pending = None   # set by the columnar finish
        self.cumulative: Result | None = None
        self.matched_count: int = 0
        self.sorted: list[Result] = []
        self.samples: list[dict] = []

    @property
    def time_results(self) -> dict[int, dict[str, Result]]:
        if self._time_pending is not None:
            pending, self._time_pending = self._time_pending, None
            _explode_time_rows(self._time_results, *pending)
        return self._time_results

    @time_results.setter
    def time_results(self, value) -> None:
        self._time_pending = None
        self._time_results = value


def _explode_time_rows(per_time, tbs, gks, key_tuples, counts, samples,
                       agg_rows):
    """Fold the columnar finish arrays into the {bucket: {gk: Result}}
    dict (combine-on-collision matches the eager path's semantics)."""
    SENT = 2**62
    for i in range(len(tbs)):
        res = Result()
        res.key_tuple = key_tuples[i]
        res.group_key = gks[i]
        res.count = counts[i]
        res.samples = samples[i]
        for col, info, ex, cnt, wv, mn, mx in agg_rows:
            if not ex[i]:
                continue
            c = cnt[i]
            res.hists[col] = BasicHist.from_sums(
                info.min, info.max, c, wv[i],
                mn[i] if c > 0 else SENT,
                mx[i] if c > 0 else -SENT)
        bucket = per_time.setdefault(tbs[i], {})
        prev = bucket.get(res.group_key)
        if prev is None:
            bucket[res.group_key] = res
        else:
            prev.combine(res)



class BoundQuery:
    """Params resolved against a table: column metadata, static scan
    config, dynamic filter constants and regex bitsets."""

    def __init__(self, table: Table, params: QueryParams, flags: Flags):
        from ..ops import scan as scanops
        self.table = table
        self.params = params
        self.flags = flags
        schema = table.schema

        self.col_types: dict[str, int] = {}

        def need(col: str, want: int, what: str):
            t = schema.col_type(col)
            if t == NO_VAL:
                error("query references unknown column", col, f"({what})")
            if want != NO_VAL and t != want:
                error("column", col, "has wrong type for", what)
            self.col_types[col] = t
            return t

        for g in params.groups:
            t = need(g, NO_VAL, "group")
            if t == SET_VAL:
                error("cannot group by set column", g)
        for d in params.distincts:
            t = need(d, NO_VAL, "distinct")
            if t == SET_VAL:
                error("cannot count distinct on set column", d)
        for a in params.aggs:
            need(a.col, INT_VAL, "aggregation")
        if params.time_bucket > 0:
            need(params.time_col, INT_VAL, "time column")
        if params.weight_col:
            need(params.weight_col, INT_VAL, "weight column")

        kinds = {"int": INT_VAL, "str": STR_VAL, "set": SET_VAL}
        filter_specs = []
        filter_vals = []
        bitsets = []
        self.display_strings: dict[str, list[str]] = {}
        for f in params.filters:
            need(f.col, kinds[f.kind], f"{f.kind} filter")
            bidx = -1
            if f.kind == "int":
                filter_vals.append(int(f.value))
            elif f.op in ("re", "nre"):
                strings = self._strings(f.col)
                rx = re.compile(f.value)
                bits = np.fromiter((rx.search(s) is not None for s in strings),
                                   dtype=bool, count=len(strings))
                if len(bits) == 0:
                    bits = np.zeros(1, dtype=bool)
                bidx = len(bitsets)
                bitsets.append(bits)
                filter_vals.append(0)
            else:
                # eq/neq/in/nin resolve the literal to its global id;
                # -1 => never-ingested string, matches nothing (eq) /
                # everything populated (neq)
                filter_vals.append(self.table.dicts.get(f.col).lookup(f.value))
            filter_specs.append(scanops.FilterSpec(f.col, f.op, f.kind, bidx))

        aggspecs = []
        self.agg_layouts = []
        for a in params.aggs:
            kid = schema.key_table[a.col]
            info = schema.int_info.get(kid)
            if info is None:
                error("no cached int info for aggregation column", a.col)
            want_hist = a.op == "hist"
            sub_edges = ()
            if want_hist and a.hist_type == "multi":
                subs = multi_hist_layout(info.min, info.max, params.hist_bucket)
                nv = sum(s[3] for s in subs)
                bs = 0
                sub_edges = tuple(subs)
            elif want_hist and a.hist_type == "tdigest":
                # -tdigest (hist_tdigest.go): value-identity buckets so
                # the sparse device hist pairs carry (near-)exact values
                # for the host t-digest; bucket only when the kept range
                # exceeds the pairkey budget
                span = max(info.max * 10 - info.min, 1)
                cap = 1 << 20
                bs = max(1, -(-span // cap))
                nv = span // bs + 2
            elif want_hist:
                bs, nv = basic_bucket_layout(info.min, info.max,
                                             params.hist_bucket)
            else:
                bs, nv = 0, 0
            self.agg_layouts.append((info, want_hist, a.hist_type))
            aggspecs.append(scanops.AggSpec(
                a.col, hist_min=info.min, bucket_size=bs, num_values=nv,
                discard_min=info.min, discard_max=info.max * 10,
                sub_edges=sub_edges))

        max_groups = flags.max_groups or INTERNAL_RESULT_LIMIT

        # dense-strategy key bounds ([time?, *groups]): str cols bound by
        # the global dictionary, int cols by table IntInfo min/max (which
        # is outlier-resistant — the scan spill-checks at runtime)
        key_bounds = []
        if params.time_bucket > 0:
            kid = schema.key_table[params.time_col]
            info = schema.int_info.get(kid)
            if info is not None and params.time_bucket:
                tb = params.time_bucket
                qmin = self._trunc_div(info.min, tb)
                qmax = self._trunc_div(info.max, tb)
                key_bounds.append((qmin, qmax - qmin + 1))
            else:
                key_bounds.append((0, 0))
        for g in params.groups:
            if self.col_types[g] == STR_VAL:
                key_bounds.append((0, max(len(table.dicts.get(g).strings), 1)))
            else:
                kid = schema.key_table[g]
                info = schema.int_info.get(kid)
                if info is None:
                    key_bounds.append((0, 0))
                else:
                    key_bounds.append((info.min, info.max - info.min + 1))

        # sorted-strategy key packing: exact only when every group key is
        # dictionary-bounded (str dict ids never exceed the dict); int
        # and time bounds come from outlier-resistant IntInfo and can be
        # exceeded at runtime, so they disqualify
        sort_pack = ()
        if (params.groups and not params.distincts
                and params.time_bucket <= 0
                and all(self.col_types[g] == STR_VAL
                        for g in params.groups)):
            sort_pack = tuple(key_bounds)

        self.config = scanops.ScanConfig(
            group_cols=params.groups,
            sort_pack=sort_pack,
            aggs=tuple(aggspecs),
            filters=tuple(filter_specs),
            distinct_cols=params.distincts,
            time_col=params.time_col if params.time_bucket > 0 else "",
            weight_col=params.weight_col,
            max_groups=max_groups,
            track_outliers=any(a.num_values > 0 for a in aggspecs),
            want_matched_mask=params.samples,
            key_bounds=tuple(key_bounds),
            # t-digest value-identity hists would blow up the dense
            # strategy's [slots, nv] bucket matrix; the sorted strategy's
            # sparse pairs carry them at no extra cost
            force_sorted=flags.force_sorted or any(
                a.op == "hist" and a.hist_type == "tdigest"
                for a in params.aggs),
        )
        self.filter_vals = np.asarray(filter_vals, dtype=np.int64)
        self.bitsets = tuple(bitsets)
        self._setup_hll()

        cols = set(params.groups) | set(params.distincts)
        cols |= {a.col for a in params.aggs}
        cols |= {f.col for f in params.filters}
        if self.config.time_col:
            cols.add(params.time_col)
        if params.weight_col:
            cols.add(params.weight_col)
        self.needed_cols = sorted(cols)

    def apply_exact_bounds(self, infos: dict, block_dirs: list[str]) -> None:
        """Derive the scan's lane limb-compression spec (ScanConfig.
        lane_limbs8 / agg_vbias) from EXACT per-block column bounds
        (BlockInfo.int_exact) over the blocks this query will scan.
        0/1-valued lanes always take one byte limb; kw/kwv lanes
        compress when the weight (and value) ranges are exactly bounded
        and nonneg-biasable.  Any block without exact stats for a column
        disables compression for the lanes that depend on it."""
        import dataclasses as _dc

        schema = self.table.schema

        def exact(col: str):
            kid = schema.key_table.get(col)
            if kid is None:
                return (0, 0)
            lo = hi = None
            for d in block_dirs:
                info = infos.get(d)
                if info is None:
                    return None
                e = getattr(info, "int_exact", {}).get(kid)
                if e is None:
                    if kid in info.int_info:
                        return None   # column present but unbounded
                    continue          # column absent: contributes nothing
                lo = e[0] if lo is None else min(lo, e[0])
                hi = e[1] if hi is None else max(hi, e[1])
            return (0, 0) if lo is None else (lo, hi)

        if self.config.weight_col:
            wb = exact(self.config.weight_col)
            if wb is not None and wb[0] >= 0:
                # rows without the weight column weigh 1
                wb = (0, max(wb[1], 1))
            else:
                wb = None
        else:
            wb = (0, 1)

        def limbs_for(maxval: int) -> int:
            if maxval < (1 << 8):
                return 1
            if maxval < (1 << 16):
                return 2
            if maxval < (1 << 32):
                return 4
            return 8

        # exact bounds also upgrade the KEY bounds: IntInfo min/max are
        # outlier-resistant and can be exceeded at runtime (dense spill
        # retry, sort_pack exclusion for int cols); int_exact bounds are
        # authoritative for the snapshot's rows, so dense int keys stop
        # spilling and int group keys become sort-packable
        p = self.params
        key_bounds = list(self.config.key_bounds)
        kb_exact = []
        ki = 0
        if self.config.time_col:
            tb = exact(self.config.time_col)
            if tb is not None and ki < len(key_bounds):
                qlo = self._trunc_div(tb[0], p.time_bucket)
                qhi = self._trunc_div(tb[1], p.time_bucket)
                key_bounds[ki] = (qlo, qhi - qlo + 1)
                kb_exact.append(True)
            else:
                kb_exact.append(False)
            ki += 1
        for g in p.groups:
            if self.col_types.get(g) == STR_VAL:
                kb_exact.append(True)      # dict-bounded, already exact
            else:
                gb = exact(g)
                if gb is not None and ki < len(key_bounds):
                    key_bounds[ki] = (gb[0], gb[1] - gb[0] + 1)
                    kb_exact.append(True)
                else:
                    kb_exact.append(False)
            ki += 1
        sort_pack = self.config.sort_pack
        if (p.groups and not p.distincts and p.time_bucket <= 0
                and all(kb_exact) and not sort_pack):
            prod = 1
            for (_, card) in key_bounds:
                prod *= card + 1
            if 0 < prod < (1 << 62):    # packed key must fit int64
                sort_pack = tuple(key_bounds)

        def fully_populated(col: str) -> bool:
            """Every scanned block has the column populated in ALL its
            rows (IntInfo.count is the per-block populated count)."""
            kid = schema.key_table.get(col)
            if kid is None:
                return False
            for d in block_dirs:
                info = infos.get(d)
                if info is None:
                    return False
                ii = info.int_info.get(kid)
                if ii is None or ii.count != info.num_records:
                    return False
            return bool(block_dirs)

        wmax = wb[1] if wb else 0
        wl = limbs_for(wmax) if wb else 8
        lanes = [wl, 1]
        row_bounds = [wmax if wb else 0, 1]   # 0 = unknown
        lane_nrows = [not p.weight_col, True]
        vbias = []
        for agg in self.config.aggs:
            lanes.append(1)          # exists
            lanes.append(wl)         # kw
            row_bounds += [1, wmax if wb else 0]
            full = fully_populated(agg.col)
            vb = exact(agg.col) if wb else None
            discard_ok = (vb is not None and vb[0] >= agg.discard_min
                          and vb[1] <= agg.discard_max)
            lane_nrows += [full,
                           full and discard_ok and not p.weight_col]
            done = False
            if vb is not None:
                vlo = max(vb[0], agg.discard_min)
                vhi = min(vb[1], agg.discard_max)
                if vhi < vlo:
                    vlo = vhi = 0
                bound = wmax * (vhi - vlo)
                if bound < (1 << 35):
                    lanes.append(limbs_for(bound))
                    row_bounds.append(bound)
                    vbias.append(int(vlo))
                    done = True
            if not done:
                lanes.append(8)
                row_bounds.append(0)
                vbias.append(0)
            lane_nrows.append(False)
        if all(x == 8 for x in lanes):
            lanes, vbias, row_bounds, lane_nrows = [], [], [], []

        # outlier machinery (masks + a top_k over all R rows per hist
        # agg) is only needed when a kept value CAN overflow the bucket
        # range; exact bounds prove the common case can't
        track_outliers = self.config.track_outliers
        if track_outliers:
            need = False
            for agg in self.config.aggs:
                if agg.num_values <= 0:
                    continue
                if agg.sub_edges:        # multihist sub-overflow: keep
                    need = True
                    break
                vbex = exact(agg.col)
                if vbex is None:
                    need = True
                    break
                top = agg.hist_min + agg.bucket_size * agg.num_values
                if min(vbex[1], agg.discard_max) >= top:
                    need = True
                    break
            track_outliers = need

        # windowed dense accumulation for rollups: digestion time-sorts
        # rows, so each block spans a narrow band of time buckets; the
        # scan kernel can then one-hot only [window, C] bands per chunk
        # (ops/scan.py _dense_reduce) instead of the full slot space
        window = 0
        window_chunk = 0
        time_i32 = False
        if self.config.time_col and kb_exact and kb_exact[0]:
            kid_t = schema.key_table.get(self.config.time_col)
            spans = {}
            tlo, thi = 2**62, -2**62
            ok = True
            for d in block_dirs:
                info = infos.get(d)
                e = (getattr(info, "int_exact", {}).get(kid_t)
                     if info else None)
                if e is None:
                    if info is not None and kid_t in info.int_info:
                        ok = False
                        break
                    continue  # block lacks the time column entirely
                qlo = self._trunc_div(e[0], p.time_bucket)
                qhi = self._trunc_div(e[1], p.time_bucket)
                spans[d] = qhi - qlo + 1
                tlo, thi = min(tlo, e[0]), max(thi, e[1])
            if ok and spans:
                # exact bounds prove the whole time column fits int32:
                # the per-row bucket division (and re-division in
                # _dense_gid) then runs at int32 speed — 64-bit div is
                # an emulated multi-pass op and was the largest rollup
                # front-end fusion in round-5 traces
                time_i32 = (-2**31 < tlo and thi < 2**31
                            and 0 < p.time_bucket < 2**31)
                # the banded kernel sweeps as many windows per chunk as
                # the chunk's real gid span needs (ops/scan.py
                # _dense_reduce), so wide straggler blocks
                # (partial-block top-ups, first digests) cost extra
                # bands, never a separate pass.  Rows within a block
                # are time-sorted, so the band loop sub-chunks at
                # window_chunk rows and the window need only cover the
                # MEDIAN block's span scaled to the sub-chunk (one-hot
                # traffic = R*window bytes — the window IS the cost)
                svals = sorted(spans.values())
                t_span = svals[len(svals) // 2]
                radix_rest = 1
                for (_, card) in key_bounds[1:]:
                    radix_rest *= card + 1
                window_chunk = 8192
                frac = max(CHUNK_SIZE // window_chunk, 1)
                t_sub = t_span // frac + 2
                window = -(-(t_sub * radix_rest) // 128) * 128

        self.config = _dc.replace(
            self.config,
            key_bounds=tuple(key_bounds), sort_pack=sort_pack,
            track_outliers=track_outliers, window=window,
            window_chunk=window_chunk, time_i32=time_i32,
            lane_limbs8=tuple(lanes), agg_vbias=tuple(vbias),
            lane_row_bounds=tuple(row_bounds),
            lane_nrows=tuple(lane_nrows))
        self._recheck_hll_cap()
        if self.params.distincts and not self.config.hll:
            # key bounds (esp. the time-bucket quotient) only exist now:
            # a time-bucketed count-distinct becomes dense-bounded here
            # and can still take the device-HLL register path
            self._setup_hll()

    def _recheck_hll_cap(self) -> None:
        """Key bounds can WIDEN after bind (exact stats, read-log dict
        growth); re-apply the device-HLL slot cap so the register array
        never balloons past the HBM budget the bind-time gate set."""
        if self.config.hll and not (0 < self.config.dense_slots <= 128):
            import dataclasses as _dc
            self.config = _dc.replace(self.config, hll=False,
                                      hll_hash_idx=-1)

    def _hll_hash_array(self, dcol: str) -> np.ndarray:
        """Per-dict-id uint64 hashes of (display string + delimiter);
        the appended last entry is the missing-value hash — bit-identical
        inputs to the host HLL slow path (_absorb_distinct)."""
        from .hll import hash64
        strings = self._strings(dcol)
        hs = np.fromiter(
            (hash64((s + GROUP_DELIMITER).encode()) for s in strings),
            dtype=np.uint64, count=len(strings))
        return np.append(hs, np.uint64(hash64(GROUP_DELIMITER.encode())))

    def _setup_hll(self) -> None:
        """Engage the device-side HLL (SURVEY §7: 2^p register array on
        device, merged by max) when the query is a single-column
        count-distinct whose group keys are dense-bounded: the scan then
        runs the DENSE strategy — no sort, no pair download — and ships
        a few 16KB register planes instead (ops/scan.py
        _hll_registers)."""
        import dataclasses as _dc
        p = self.params
        cfg = self.config
        if (len(p.distincts) != 1 or cfg.force_sorted
                or self.flags.data_shards > 1):
            return
        cand = _dc.replace(cfg, hll=True)
        # slots*HLL_M uint8 registers live in HBM; 128 groups = 2MB and
        # bounds the worst-case escalation download
        if not cand.dense_slots or cand.dense_slots > 128:
            return
        dcol = p.distincts[0]
        if self.col_types[dcol] == STR_VAL:
            if len(self.table.dicts.get(dcol).strings) > 65536:
                return
            self.bitsets = self.bitsets + (self._hll_hash_array(dcol),)
            cand = _dc.replace(cand, hll_hash_idx=len(self.bitsets) - 1)
        self.config = cand

    @staticmethod
    def _trunc_div(x: int, d: int) -> int:
        q = abs(x) // d
        return q if x >= 0 else -q

    def refresh_str_filters(self) -> None:
        """Re-resolve str/set filter literals and regex bitsets against the
        current dictionaries.  The -read-log path ingests rowstore strings
        into the in-memory dicts *after* bind time (rows_to_columns), so a
        literal that only exists in undigested WAL rows resolves to -1
        unless refreshed."""
        filter_vals = []
        bitsets = []
        self.display_strings.clear()
        for f in self.params.filters:
            if f.kind == "int":
                filter_vals.append(int(f.value))
            elif f.op in ("re", "nre"):
                strings = self._strings(f.col)
                rx = re.compile(f.value)
                bits = np.fromiter((rx.search(s) is not None for s in strings),
                                   dtype=bool, count=len(strings))
                if len(bits) == 0:
                    bits = np.zeros(1, dtype=bool)
                bitsets.append(bits)
                filter_vals.append(0)
            else:
                filter_vals.append(self.table.dicts.get(f.col).lookup(f.value))
        self.filter_vals = np.asarray(filter_vals, dtype=np.int64)
        self.bitsets = tuple(bitsets)
        if self.config.hll and self.config.hll_hash_idx >= 0:
            # the dict may have grown (read-log strings): rebuild the
            # per-id hash array at its new index
            import dataclasses as _dc
            self.bitsets = self.bitsets + (
                self._hll_hash_array(self.params.distincts[0]),)
            self.config = _dc.replace(self.config,
                                      hll_hash_idx=len(self.bitsets) - 1)

    def refresh_key_bounds(self) -> None:
        """Re-derive str group-key bounds from the CURRENT dictionaries.
        The -read-log path ingests WAL strings into the in-memory dicts
        after bind time; stale bounds would spill every pseudo-block to
        the unpacked fallback (dense digits and the packed sort key are
        runtime-guarded, so this is a fast-path refresh, not a
        correctness requirement)."""
        import dataclasses as _dc
        p = self.params
        kb = list(self.config.key_bounds)
        ki = 1 if self.config.time_col else 0
        changed = False
        for g in p.groups:
            if self.col_types.get(g) == STR_VAL and ki < len(kb):
                card = max(len(self.table.dicts.get(g).strings), 1)
                if kb[ki] != (0, card):
                    kb[ki] = (0, card)
                    changed = True
            ki += 1
        if not changed:
            return
        sort_pack = self.config.sort_pack
        if sort_pack and not self.config.time_col and \
                len(sort_pack) == len(kb):
            sort_pack = tuple(kb)
        self.config = _dc.replace(self.config, key_bounds=tuple(kb),
                                  sort_pack=sort_pack)
        self._recheck_hll_cap()

    def _strings(self, col: str) -> list[str]:
        """Global dict strings with -str-replace applied (the reference
        rewrites strings at decode, column_store_io.go:517-546, so both
        regex filters and display see replaced values)."""
        if col in self.display_strings:
            return self.display_strings[col]
        strings = list(self.table.dicts.get(col).strings)
        rep = self.params.str_replace.get(col)
        if rep:
            rx = re.compile(rep[0])
            strings = [rx.sub(rep[1], s) for s in strings]
        self.display_strings[col] = strings
        return strings

    # ------------------------------------------------------------------
    def should_scan_block(self, info: blockio.BlockInfo) -> bool:
        """Min/max block pruning (table_block_io.go:110-182): only int
        gt/lt/eq filters participate."""
        if not info.int_info:
            return True
        schema = self.table.schema
        for i, f in enumerate(self.params.filters):
            if f.kind != "int" or f.op not in ("gt", "lt", "eq"):
                continue
            kid = schema.key_table.get(f.col)
            ii = info.int_info.get(kid)
            v = int(f.value)
            if ii is None:
                return False  # filter requires a column this block lacks
            if f.op == "gt" and ii.max <= v:
                return False
            if f.op == "lt" and ii.min >= v:
                return False
            if f.op == "eq" and (ii.min > v or ii.max < v):
                return False
        return True


def _pad_pow2(n: int, floor: int = 128) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def pad_set_csr(rows, vals, R: int):
    """A batch's set-column CSR padded to a power of two (at least 128)
    entries, as the loader keeps it: row ids int32 (pad R) and values
    int64 (pad -2)."""
    m = _pad_pow2(max(len(rows), 1))
    prow = np.full(m, R, dtype=np.int32)
    pval = np.full(m, -2, dtype=np.int64)
    prow[:len(rows)] = rows
    pval[:len(vals)] = vals
    return prow, pval


def shard_set_csr(rows, vals, shards: int, R_local: int):
    """A batch's set-column CSR split into the mesh's contiguous shards
    (reference engine.py:886-904): -> (prow int32 [shards, M], pval int64
    [shards, M], entries per shard), row ids shard-local, one power-of-two
    width M for all (pads: row R_local, value -2)."""
    shard = rows // R_local
    per = [np.nonzero(shard == d)[0] for d in range(shards)]
    m = _pad_pow2(max([len(p) for p in per] + [1]))
    prow = np.full((shards, m), R_local, dtype=np.int32)
    pval = np.full((shards, m), -2, dtype=np.int64)
    for d, p in enumerate(per):
        prow[d, :len(p)] = rows[p] - d * R_local
        pval[d, :len(p)] = vals[p]
    return prow, pval, tuple(len(p) for p in per)


class BatchLoader:
    """Assembles [B, C] device tensors for a batch of blocks, reusing the
    device-resident column cache: each (batch, column) decodes once and
    later scans only read resident tensors (ops/residency.py).  A set
    column becomes the batch's flattened CSR, also resident."""

    def __init__(self, bound: BoundQuery, block_dirs: list[str], C: int,
                 expected: dict[str, int] | None = None, device="cuda",
                 shards: int = 0):
        self.bound = bound
        self.block_dirs = block_dirs
        self.C = C
        self.device = device
        # > 0: the mesh's data shards among block_dirs, each with a set
        # column CSR of its own
        self.shards = shards
        # num_records per block as captured at query start; a column whose
        # decoded length disagrees means the block was republished between
        # the info read and the column load — skip it, mirroring the
        # reference's "BLOCK SIZE CHANGED DURING QUERY" guard
        # (column_store_io.go:525,572,592,734,751)
        self.expected = expected or {}
        self.changed: set[str] = set()

    def _resident_col(self, bdir: str, name: str, typ: int):
        """Host decode of one block column -> (values[C], valid[C],
        n_records); n_records is -1 when the block lacks the column file.
        Only for containers the device decoder refuses (ValueError)."""
        import torch

        from ..ops.residency import CACHE, block_col_key

        C = self.C
        key = block_col_key(bdir, blockio.column_file(typ, name), name, C) \
            + (str(self.device),)
        ent = CACHE.get(key)
        if ent is not None:
            self._check_block(bdir, ent[2])
            return ent
        try:
            data = blockio.load_block_columns(
                bdir, self.bound.table.schema, [name]).get(name)
        except Exception as e:  # noqa: BLE001 - torn/corrupt block file
            warn("corrupt column file; skipping block", bdir, e)
            self.changed.add(bdir)
            data = None
        values = np.zeros(C, dtype=np.int64)
        valid = np.zeros(C, dtype=bool)
        ncol = -1
        if isinstance(data, blockio.IntColumnData):
            ncol = len(data.values)
            n = min(ncol, C)
            values[:n] = data.values[:n]
            valid[:n] = data.valid[:n]
        elif isinstance(data, blockio.StrColumnData):
            ncol = len(data.ids)
            n = min(ncol, C)
            values[:n] = data.ids[:n]
            valid[:n] = data.valid[:n]
        ent = (torch.from_numpy(values).to(self.device),
               torch.from_numpy(valid).to(self.device), ncol)
        CACHE.put(key, ent)
        return ent

    def _decode_batch_device(self, name: str, typ: int):
        """Batched DEVICE decode of one column (ops/decode.py): mmap the
        raw encoded sections, pad into batch arrays, decode with K1.
        Returns (values [B, C], valid [B, C], ncols) or None to fall
        back to the host decoder (shapes the reference also sends
        there)."""
        from ..ops.decode import classify_containers, decode_column_batch
        containers = []
        for bdir in self.block_dirs:
            try:
                containers.append(blockio.open_column(bdir, typ, name))
            except Exception as e:  # noqa: BLE001 - torn/corrupt file:
                # skip the block (the reference demotes half-written
                # blocks and tolerates concurrent rewrites; a torn file
                # must never kill the whole query)
                warn("corrupt column file; skipping block", bdir, e)
                self.changed.add(bdir)
                containers.append(None)
        try:
            classify_containers(containers, self.C)
        except ValueError as e:
            debug("device decode fallback for", name, ":", e)
            return None
        # outside the try: an error of the kernel or its wrapper raises
        return decode_column_batch(containers, self.C, self.device)

    def _check_block(self, bdir: str, ncol: int) -> None:
        exp = self.expected.get(bdir)
        if ncol >= 0 and exp is not None and ncol != exp:
            if bdir not in self.changed:
                warn("BLOCK SIZE CHANGED DURING QUERY", bdir,
                     f"({exp} -> {ncol}); skipping block")
            self.changed.add(bdir)

    def load(self):
        """-> (cols {name: (values, valid)}, nrec int32 [B] numpy,
        set_aux {set column: (prow int32 [M], pval int64 [M], n)}): a set
        column's per-block CSR flattened into batch row ids (block bi's
        rows offset by bi * C) and values, padded to a power of two M
        with row R and value -2, n real entries.  With shards, each
        shard's CSR: prow and pval [shards, M], shard-local row ids (pad
        R_local), and n a tuple of each shard's entries."""
        import torch

        from ..ops.residency import CACHE, block_col_key

        bound = self.bound
        B = len(self.block_dirs)
        C = self.C
        R = B * C
        schema = bound.table.schema
        nrec = np.zeros(B, dtype=np.int32)
        cols = {}
        set_cols: dict[str, list] = {}

        dense_names = [n for n in bound.needed_cols
                       if bound.col_types[n] != SET_VAL]
        for name in bound.needed_cols:
            if bound.col_types[name] == SET_VAL:
                set_cols[name] = []

        for bi, bdir in enumerate(self.block_dirs):
            exp = self.expected.get(bdir)
            if exp is None:
                # no snapshot (direct loader use): read the info now
                info = blockio.load_block_info(bdir)
                exp = info.num_records if info else 0
            # record counts come from the info snapshot taken at query
            # start; staleness is caught by the column-length checks below
            nrec[bi] = min(exp, C)

        # set columns get the dense lanes' residency: the per-block CSR
        # is cached on the host (no disk re-read per batch per query) and
        # the padded batch arrays stay on the device, keyed like the
        # dense batch entries, so a warm set-filter query uploads nothing
        set_batch_keys = {}
        set_dev: dict[str, tuple] = {}
        set_ncols: dict[str, list] = {}
        for name in set_cols:
            bkeys = tuple(
                block_col_key(bdir, blockio.column_file(SET_VAL, name),
                              name, C) for bdir in self.block_dirs)
            set_batch_keys[name] = ("set_batch", name, bkeys,
                                    str(self.device), self.shards)
            ent = CACHE.get(set_batch_keys[name])
            if ent is not None:
                set_dev[name] = ent
                continue
            ncols = set_ncols[name] = [-1] * B
            for bi, bdir in enumerate(self.block_dirs):
                if not nrec[bi]:
                    continue
                ck = ("setcsr",) + bkeys[bi]
                cd = CACHE.get(ck)
                if cd is None:
                    try:
                        raw = blockio.load_block_columns(
                            bdir, schema, [name]).get(name)
                    except Exception as e:  # noqa: BLE001 - torn file
                        warn("corrupt set column; skipping block",
                             bdir, e)
                        self.changed.add(bdir)
                        continue
                    if raw is None:
                        # the block lacks the column (written before it
                        # existed): no entries, so neither in nor nin
                        # passes a row of it.  The reference raises here
                        # (its `raw.offsets` of None)
                        cd = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                              -1)
                    else:
                        ncol = len(raw.offsets) - 1
                        rows = np.repeat(np.arange(ncol),
                                         np.diff(raw.offsets))
                        cd = (rows, raw.values, ncol)
                    CACHE.put(ck, cd)
                self._check_block(bdir, cd[2])
                ncols[bi] = cd[2]
                set_cols[name].append((cd[0] + bi * C, cd[1]))

        for name in dense_names:
            typ = bound.col_types[name]
            block_keys = tuple(
                block_col_key(bdir, blockio.column_file(typ, name), name, C)
                for bdir in self.block_dirs)
            batch_key = ("batch", name, block_keys, str(self.device))
            ent = CACHE.get(batch_key)
            if ent is None:
                ent = self._decode_batch_device(name, typ)
                if ent is None:
                    # host-decode fallback: stack per-block resident lanes
                    lanes = [self._resident_col(bdir, name, typ)
                             for bdir in self.block_dirs]
                    ent = (torch.stack([e[0] for e in lanes]),
                           torch.stack([e[1] for e in lanes]),
                           tuple(e[2] for e in lanes))
                CACHE.put(batch_key, ent)
            for bdir, ncol in zip(self.block_dirs, ent[2]):
                self._check_block(bdir, ncol)
            cols[name] = (ent[0], ent[1])

        if not cols:
            # bare count(*) or set-only query: synthesize one lane so the
            # kernel has a shape to scan; row_in_range does the counting
            cols["__count__"] = (
                torch.zeros((B, C), dtype=torch.int64, device=self.device),
                torch.ones((B, C), dtype=torch.bool, device=self.device))

        set_aux = {}
        for name, chunks in set_cols.items():
            if name in set_dev:
                prow_d, pval_d, ncols, n = set_dev[name]
                for bdir, ncol in zip(self.block_dirs, ncols):
                    self._check_block(bdir, ncol)
                set_aux[name] = (prow_d, pval_d, n)
                continue
            if chunks:
                rows = np.concatenate([c[0] for c in chunks])
                vals = np.concatenate([c[1] for c in chunks]).astype(np.int64)
            else:
                rows = np.zeros(0, dtype=np.int64)
                vals = np.zeros(0, dtype=np.int64)
            if self.shards:
                prow, pval, n = shard_set_csr(rows, vals, self.shards,
                                              (B // self.shards) * C)
            else:
                prow, pval = pad_set_csr(rows, vals, R)
                n = len(rows)
            dev = (torch.from_numpy(prow).to(self.device),
                   torch.from_numpy(pval).to(self.device))
            CACHE.put(set_batch_keys[name],
                      (dev[0], dev[1], tuple(set_ncols[name]), n))
            set_aux[name] = (dev[0], dev[1], n)
        if self.changed:
            # zero out changed blocks so the kernel scans nothing from
            # them, after EVERY staleness probe has run, the set-batch
            # cache hits above included (a set-only query's one
            # _check_block sits in that loop)
            for bi, bdir in enumerate(self.block_dirs):
                if bdir in self.changed:
                    nrec[bi] = 0
        return cols, nrec, set_aux


def run_query(table: Table, params: QueryParams,
              flags: Flags | None = None) -> QueryResults:
    from ..profiler import PhaseTimer
    timer = PhaseTimer()

    # the reference disables Go GC for the duration of a query
    # (cmd_query.go:353, re-enabled above MAX_MEM table_query.go:286);
    # CPython's generational GC likewise costs 10s of ms per collection
    # once the process heap holds block arrays — pause it for the query
    import gc
    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    try:
        return _run_query_inner(table, params, flags, timer)
    finally:
        if gc_was_enabled:
            gc.enable()


def _run_query_inner(table: Table, params: QueryParams,
                     flags: Flags | None, timer) -> QueryResults:
    from ..ops.kernels import resolve_device
    flags = flags or table.flags
    device = resolve_device(flags.device)
    with timer.phase("bind"):
        if not table.load_info() and not table.exists():
            error("table", table.name,
                  "can not be loaded or does not exist in", flags.dir)
        bound = BoundQuery(table, params, flags)

    with timer.phase("list_blocks"):
        infos = table.block_infos()
        block_dirs = [d for d, info in infos.items()
                      if bound.should_scan_block(info)]
        bound.apply_exact_bounds(infos, block_dirs)
    skipped = len(infos) - len(block_dirs)
    if skipped:
        debug("skipped", skipped, "blocks via min/max pruning")

    maxrec = max((infos[d].num_records for d in block_dirs), default=0)
    C = CHUNK_SIZE if maxrec > 8192 else _pad_pow2(max(maxrec, 1))
    B = max(1, min(flags.device_batch, max(len(block_dirs), 1)))

    from ..parallel import multihost as mh
    mesh = None
    mh.init_distributed(flags)
    if mh.is_multiprocess() and flags.data_shards <= 1:
        # N processes, one mesh: a shard a process by default
        flags.data_shards = mh.process_count()
    if flags.data_shards > 1:
        import dataclasses as _dc

        from ..parallel.mesh import Mesh
        D = flags.data_shards
        nproc = mh.process_count()
        if D % nproc:
            error("data-shards", D, "must divide evenly across", nproc,
                  "processes")
        import torch.distributed as dist
        mesh = Mesh(D, dist.group.WORLD if nproc > 1 else None)
        B = _mesh_batch(mesh, B)
        # the HLL's register planes do not ride the shuffle payload (the
        # sorted pair path instead), and shuffled table rows are not
        # slot-aligned (the keyed table on the wire)
        bound.config = _dc.replace(bound.config, no_compact_table=True,
                                   **({"hll": False, "hll_hash_idx": -1}
                                      if bound.config.hll else {}))

    ctx = _ScanCtx(bound, infos, params, timer, C, device, mesh)
    if flags.cache_queries and not params.samples and not flags.read_log:
        acc = _cached_scan(ctx, table, block_dirs, B)
    else:
        _maybe_device_prune(bound, params, block_dirs, B)
        acc = _scan_dirs(ctx, block_dirs, B, allow_prune=True)

    if flags.read_log:
        with timer.phase("rowstore"):
            _scan_rowstore(acc, ctx, table)

    with timer.phase("finish"):
        qr = acc.finish()
    timer.report("query")
    return qr


def _cached_scan(ctx: "_ScanCtx", table: Table, block_dirs: list[str],
                 B: int) -> "_Accumulator":
    """-cache-queries (the reference's engine.py:1010-1143): each stable
    group of 16 full blocks answers from its cache file when one exists,
    and the missed groups are scanned and written.  Groups are formed
    over ALL full blocks, never the min/max-pruned list, so a changed
    filter constant cannot shift group boundaries; a pruned block is
    skipped inside its group's scan, and a wholly pruned group is cached
    as an empty partial.  The missed groups share one batch pipeline:
    many a dispatch through the cache-group key (_scan_cache_vgroups)
    when a vgroup config fits the dense or sorted strategy, else one
    group a batch (_scan_dirs(groups=...)).  The blocks outside any group
    (partial blocks, the trailing remainder) are scanned uncached, as
    extra vgroups when those run.  No device prune in cache mode: a
    cached partial must be exact."""
    import dataclasses as _dc

    from ..parallel import multihost as mh
    from . import cache as qcache
    bound, params, timer = ctx.bound, ctx.params, ctx.timer
    infos = ctx.infos
    acc = _Accumulator(bound)
    with timer.phase("cache_probe"):
        scanset = set(block_dirs)
        groups, rest = qcache.stable_groups(list(infos), infos)
        rest = [d for d in rest if d in scanset]
        missed: list[tuple[str, list[str]]] = []
        hits = 0
        for gdirs in groups:
            k = qcache.group_cache_key(params, table, gdirs, infos)
            cached = qcache.load_group_rows(table, k, bound)
            if cached is None:
                missed.append((k, gdirs))
            else:
                acc.merge_from(cached)
                hits += 1
    if hits:
        debug("query cache:", hits, "group hits,", len(missed), "misses,",
              len(rest), "uncacheable blocks")
    missed_live = [(k, [d for d in gdirs if d in scanset])
                   for k, gdirs in missed]
    group_accs = {}
    if not acc.distinct_limit_hit():
        to_scan = [(k, live) for k, live in missed_live if live]
        # the largest power-of-two vgroup count whose config still fits
        # the dense budget (a windowed rollup's download, the HLL planes)
        # or, unbounded, the sorted strategy
        use_vg = False
        vg_cap = 1
        # a mesh's shuffled rows are not slot-aligned: no vgroups there
        if to_scan and ctx.mesh is None and B >= qcache.GROUP_SIZE and all(
                len(g) <= qcache.GROUP_SIZE for _, g in to_scan):
            ng_try = max(1, min(len(to_scan),
                                max(1, B // qcache.GROUP_SIZE)))
            ngp = 1
            while ngp < ng_try:
                ngp *= 2
            while ngp >= 1:
                probe = _dc.replace(
                    bound.config,
                    group_cols=("__cg__",) + bound.config.group_cols,
                    key_bounds=((0, ngp),) + bound.config.key_bounds,
                    sort_pack=(), vg_span=qcache.GROUP_SIZE)
                ok_dense = probe.dense_slots > 0 and (
                    not probe.hll or probe.dense_slots <= 1024) and (
                    probe.window == 0 or probe.dense_slots <= 16384)
                ok_sorted = probe.dense_slots == 0 and not probe.hll
                if ok_dense or ok_sorted:
                    use_vg = True
                    vg_cap = ngp
                    if ok_sorted and bound.config.distinct_cols:
                        # the pair section grows with the group count
                        vg_cap = min(ngp, 2)
                    break
                ngp //= 2
        if to_scan and use_vg:
            vg_groups = list(to_scan)
            GS = qcache.GROUP_SIZE
            rest_keys = []
            for j in range(0, len(rest), GS):
                rk = ("__REST__", j)
                rest_keys.append(rk)
                vg_groups.append((rk, rest[j: j + GS]))
            group_accs = _scan_cache_vgroups(ctx, vg_groups, B, vg_cap)
            for rk in rest_keys:
                ra = group_accs.pop(rk, None)
                if ra is not None:
                    acc.merge_from(ra)
            rest = []
        elif to_scan:
            # one group a batch: a group is GROUP_SIZE blocks, so a
            # larger batch would only pad it (to a mesh multiple)
            group_accs = _scan_dirs(ctx, [],
                                    _mesh_batch(ctx.mesh,
                                                min(B, qcache.GROUP_SIZE)),
                                    allow_prune=False, groups=to_scan)
    for k, live in missed_live:
        if live:
            sub = group_accs.get(k)
            if sub is None:
                continue    # the distinct limit stopped the scan first:
                            # a group not scanned is never cached
        else:               # every block pruned: cache the empty partial
            sub = _Accumulator(bound)
        if mh.is_printer():   # one writer per mesh; the others share disk
            with timer.phase("cache_save"):
                qcache.save_group_rows(table, k, sub)
        acc.merge_from(sub)
        acc.maybe_prune()
    if rest and not acc.distinct_limit_hit():
        sub = _scan_dirs(ctx, rest, _mesh_batch(ctx.mesh, min(B, len(rest))),
                         allow_prune=False)
        acc.merge_from(sub)
        acc.maybe_prune()
    return acc


def _mesh_batch(mesh, B: int) -> int:
    """A batch size rounded UP to a multiple of the mesh's shards (down
    would split, say, 31 blocks over 2 shards into two full-shape padded
    batches)."""
    if mesh is None:
        return B
    return -(-B // mesh.D) * mesh.D


def _maybe_device_prune(bound: BoundQuery, params: QueryParams,
                        block_dirs: list[str], B: int) -> None:
    """Ask for PruneResults on the device (ScanConfig.prune_topk), as the
    reference does (engine.py:1158-1190): when a scan spans more than
    CHUNKS_BEFORE_GC = 16 blocks, has plain-count/avg aggregations, no
    time rollup and no distinct, and prunes by $COUNT or an aggregation's
    mean, each batch ships only its top 10*limit (<= 1000) group rows and
    the whole batch's count and sample totals.  The dense strategy ignores
    it; exactly bounded keys past the dense caps take the enumerated
    strategy (enum_radix), every other group-by the sorted strategy's
    device prune."""
    import dataclasses as _dc

    p = params
    if not p.prune_by or p.limit <= 0 or len(block_dirs) <= 16:
        return
    if p.distincts or p.time_bucket > 0:
        return
    if any(a.num_values > 0 for a in bound.config.aggs):
        return
    pagg = -1
    if p.prune_by != SORT_COUNT:
        cols = [a.col for a in p.aggs]
        if p.prune_by not in cols:
            return
        pagg = cols.index(p.prune_by)
    cap = min(p.limit * 10, 1000)
    bound.config = _dc.replace(bound.config, prune_topk=cap,
                               prune_agg=pagg)


class _ScanCtx:
    """Shared per-query scan state threaded through _scan_dirs."""

    def __init__(self, bound, infos, params, timer, C, device, mesh=None):
        self.bound = bound
        self.infos = infos
        self.params = params
        self.timer = timer
        self.C = C
        self.device = device
        self.mesh = mesh          # parallel/mesh.py Mesh, or None
        self.refresh_consts()

    def refresh_consts(self):
        """Filter constants, regex bitsets and the device HLL's uint64
        hash array (as int64 bits) as device constants; call again after
        BoundQuery.refresh_str_filters re-resolves them."""
        from ..ops.residency import device_const
        self.jfv = device_const(self.bound.filter_vals, self.device)
        self.jbits = tuple(
            device_const(b.view(np.int64) if b.dtype == np.uint64 else b,
                         self.device) for b in self.bound.bitsets)


PIPELINE = 4   # batches in flight before the oldest download blocks


def _start_d2h(packed) -> None:
    """Start the device->host copy of a batch's packed buffer as soon as
    it is dispatched, into pinned memory and without blocking: the drain
    loop then waits on an event instead of paying one synchronous copy
    per batch after the fact."""
    import torch
    main = packed["main"]
    if main.device.type != "cuda":
        return
    host = torch.empty(main.shape, dtype=main.dtype, pin_memory=True)
    host.copy_(main, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(main.device))
    packed["host"] = (host, done)


def fetch_main(packed) -> np.ndarray:
    """The one download of a batch: its packed `main` buffer as numpy."""
    if "host" in packed:
        host, done = packed["host"]
        done.synchronize()
        return host.numpy()
    return packed["main"].cpu().numpy()


def _scan_cache_vgroups(ctx: _ScanCtx, groups, B: int, vg_cap: int):
    """Scan many 16-block cache groups a dispatch (the reference's
    engine.py:1193-1331): the config gains the cache-group key "__cg__"
    (vg_span = GROUP_SIZE), which the kernels make from each row's block
    position, as the most significant key, so the download's rows carry
    (cache group, *keys) and the host splits them into one accumulator a
    group.  A chunk of up to vg_cap groups is padded to a power of two
    of them, padding blocks and a partial group's padding at nrec = 0;
    the per-batch caps (HLL planes shipped, distinct pairs, hist pairs,
    outlier rows) scale with the group count; a chunk whose dense key
    bound spills is redone alone, blocking, on the sorted strategy.
    Dispatches pipeline as _scan_dirs's do.  -> {key: acc}."""
    import dataclasses as _dc

    from ..ops.residency import device_const
    from ..ops.scan import scan_packed
    from . import cache as qcache

    bound, timer, C, device = ctx.bound, ctx.timer, ctx.C, ctx.device
    tb = ctx.params.time_bucket or 1
    GS = qcache.GROUP_SIZE
    ngrp_max = max(1, min(B // GS, vg_cap))
    accs: dict = {}

    def dispatch_chunk(chunk, force_sorted: bool):
        ng = len(chunk)
        # a power of two of groups: one config a size class
        ngp = 1
        while ngp < ng:
            ngp *= 2
        dirs = []
        pad_pos = []
        for _, gdirs in chunk:
            gg = list(gdirs)[:GS]
            while len(gg) < GS:      # a partial (rest) group: pad, zero
                pad_pos.append(len(dirs) + len(gg))
                gg.append(gg[-1])
            dirs += gg
        real = len(dirs)
        if ngp > ng:
            dirs = dirs + [dirs[-1]] * ((ngp - ng) * GS)
        base = bound.config
        vcfg = _dc.replace(
            base,
            group_cols=("__cg__",) + base.group_cols,
            key_bounds=((0, ngp),) + base.key_bounds,
            sort_pack=(), vg_span=GS,
            hll_ship=max(base.hll_ship, 2 * ngp) if base.hll
            else base.hll_ship,
            # ngp groups share one batch: the per-batch compaction caps
            # scale, or every vgroup dispatch escalates
            max_pairs=min(base.max_pairs * ngp, 1 << 20),
            max_hist_pairs=min(base.max_hist_pairs * ngp, 1 << 20),
            max_out=min(base.max_out * ngp, 1 << 18),
            force_sorted=force_sorted or base.force_sorted)
        with timer.phase("load"):
            loader = BatchLoader(bound, dirs, C,
                                 {d: ctx.infos[d].num_records
                                  for d in dirs if d in ctx.infos}, device)
            cols, nrec, set_aux = loader.load()
            nrec[real:] = 0          # padding blocks contribute nothing
            for pp in pad_pos:       # nor a partial group's padding
                nrec[pp] = 0
            Bc = len(dirs)
        with timer.phase("dispatch"):
            packed, out = scan_packed(vcfg, cols, device_const(nrec, device),
                                      ctx.jfv, ctx.jbits, tb, set_aux)
        _start_d2h(packed)
        return vcfg, packed, out, Bc

    def drain_chunk(chunk, vcfg, packed, out, Bc):
        tmp = _Accumulator(bound)
        tmp.prune_cap = 0
        with timer.phase("drain"):
            spill = tmp.absorb_packed(packed, out, Bc * C, vcfg)
        if spill > 0:
            # a key fell outside its declared bound: redo this chunk
            # alone, blocking, on the unpacked sorted strategy
            debug("vgroup scan spilled; retrying unpacked sorted")
            vcfg2, packed2, out2, Bc2 = dispatch_chunk(chunk, True)
            tmp = _Accumulator(bound)
            tmp.prune_cap = 0
            with timer.phase("drain"):
                tmp.absorb_packed(packed2, out2, Bc2 * C, vcfg2)
        ng = len(chunk)
        split_rows: list[dict] = [dict() for _ in range(ng)]
        split_matched = [0] * ng
        split_batches: list[list] = [[] for _ in range(ng)]
        if tmp.np_batches and not tmp.rows:
            # columnar split by the leading cache-group key: each group's
            # partial stays a parked numpy batch (written columnar, and
            # merged back columnar on a hit)
            for ak, counts, samples, aggs in tmp.np_batches:
                cg = ak[:, 0]
                for j in range(ng):
                    sel = np.nonzero(cg == j)[0]
                    if not len(sel):
                        continue
                    split_batches[j].append((
                        ak[sel][:, 1:], counts[sel], samples[sel],
                        [(ex[sel], cnt[sel], wv[sel], mn[sel], mx[sel])
                         for (ex, cnt, wv, mn, mx) in aggs]))
                    split_matched[j] += int(samples[sel].sum())
            tmp.np_batches = []
        else:
            # hist lanes, distinct registers or pairs: a split by dict
            tmp._materialize()
            for kt, row in tmp.rows.items():
                j = kt[0]
                if 0 <= j < ng:
                    split_rows[j][kt[1:]] = row
                    split_matched[j] += row["samples"]
        for j, (k, _) in enumerate(chunk):
            a = _Accumulator(bound)
            a.prune_cap = 0
            a.rows = split_rows[j]
            a.np_batches = split_batches[j]
            a.matched_count = split_matched[j]
            a.batches = 1
            accs[k] = a

    pending: list[tuple] = []
    for start in range(0, len(groups), ngrp_max):
        chunk = groups[start: start + ngrp_max]
        pending.append((chunk, *dispatch_chunk(chunk, False)))
        if len(pending) >= PIPELINE:
            drain_chunk(*pending.pop(0))
    while pending:
        drain_chunk(*pending.pop(0))
    return accs


def _scan_dirs(ctx: _ScanCtx, block_dirs: list[str], B: int,
               allow_prune: bool, groups=None):
    """Scan a set of block dirs into a fresh accumulator through the
    batch pipeline: up to PIPELINE batches are in flight before the
    oldest one's download is absorbed, and a samples query then reads
    the batch's matched rows until it holds 4 * limit.  When a batch
    reports a dense key bound spill, the whole scan restarts once on
    the unpacked sorted strategy, with fresh accumulators, as the
    reference's does (engine.py:1379-1592).  Under a mesh each batch is
    a sharded_scan (parallel/mesh.py) packed once; a process of a
    multi-process mesh loads only its span of each batch.

    groups: [(key, dirs), ...] or None.  When given, every group's
    batches ride the one pipeline but land in an accumulator of their
    own, the distinct limit counts the union of the groups, and the
    return value is {key: acc} for the groups whose batches all
    completed (the query cache writes each one)."""
    import dataclasses as _dc

    from ..ops.residency import device_const
    from ..ops.scan import pack_parts, scan_packed
    from ..parallel.mesh import sharded_scan

    bound, params, timer = ctx.bound, ctx.params, ctx.timer
    C, device, infos, mesh = ctx.C, ctx.device, ctx.infos, ctx.mesh
    nproc, pid = (mesh.nproc, mesh.pid) if mesh else (1, 0)
    if groups is None:
        work = [(None, block_dirs[s: s + B])
                for s in range(0, len(block_dirs), B)]
        all_dirs = list(block_dirs)
    else:
        work = [(k, dirs[s: s + B]) for k, dirs in groups
                for s in range(0, len(dirs), B)]
        all_dirs = [d for _, dirs in groups for d in dirs]
    n_batches: dict = {}
    for k, _ in work:
        n_batches[k] = n_batches.get(k, 0) + 1
    expected = {d: infos[d].num_records for d in all_dirs if d in infos}

    for attempt in range(2):
        accs: dict = {}
        drained: dict = {}

        def get_acc(k):
            a = accs.get(k)
            if a is None:
                a = accs[k] = _Accumulator(bound)
                if not allow_prune:
                    a.prune_cap = 0
            return a

        acc = get_acc(None) if groups is None else None
        pending: list[tuple] = []
        spilled = False

        def drain_one() -> bool:
            gkey, cfg, packed, out, R, batch_dirs, nrec = pending.pop(0)
            a = get_acc(gkey)
            if a.absorb_packed(packed, out, R, cfg) > 0:
                return False
            drained[gkey] = drained.get(gkey, 0) + 1
            if allow_prune:
                a.maybe_prune()
            if params.samples and groups is None and \
                    len(a.sample_rows) < max(params.limit, 1) * 4:
                a.collect_samples(out, batch_dirs, nrec, C)
            return True

        def stop_early() -> bool:
            if params.num_distinct <= 0:
                return False
            if groups is None:
                return allow_prune and acc.distinct_limit_hit()
            # the distinct groups over the UNION of the per-group
            # partials: a sum of per-accumulator counts would count a key
            # shared by two cache groups twice and stop early
            seen = set()
            for a in accs.values():
                a._materialize()
                for kt in a.rows:
                    seen.add(a._group_part(kt))
            return len(seen) >= params.num_distinct

        for gkey, batch in work:
            if stop_early():
                break
            cfg = bound.config
            batch_dirs = batch + [batch[-1]] * (B - len(batch))  # pad
            R = B * C
            # a process of a multi-process mesh loads and scans only its
            # span of the batch (one process: all of it)
            Bl = B // nproc
            lo = pid * Bl
            with timer.phase("load"):
                loader = BatchLoader(bound, batch_dirs[lo: lo + Bl], C,
                                     expected, device,
                                     shards=mesh.Dl if mesh else 0)
                cols, nrec, set_aux = loader.load()
            # padded repeats contribute nothing
            nrec[max(0, min(len(batch) - lo, Bl)):] = 0
            nrec_all = nrec
            if nproc > 1:
                # the samples walk reads the whole batch's blocks
                nrec_all = np.array([min(expected.get(d, 0), C)
                                     for d in batch_dirs], dtype=np.int32)
                nrec_all[len(batch):] = 0
            with timer.phase("dispatch"):
                jnrec = device_const(nrec, device)
                tb = params.time_bucket or 1
                if mesh is None:
                    packed, out = scan_packed(cfg, cols, jnrec, ctx.jfv,
                                              ctx.jbits, tb, set_aux)
                else:
                    parts = sharded_scan(cfg, mesh, cols, jnrec, ctx.jfv,
                                         ctx.jbits, tb, set_aux)
                    packed, out = pack_parts(cfg, parts), parts["raw"]
            # the raw outputs stay beside the packed buffer until it
            # drains: escalation fetches from them when a packed section
            # overflows, and a samples query reads its matched mask
            pending.append((gkey, cfg, packed, out, R, batch_dirs,
                            nrec_all))
            _start_d2h(packed)
            if len(pending) >= PIPELINE:
                with timer.phase("drain"):
                    if not drain_one():
                        spilled = True
                        break
        while not spilled and pending:
            if stop_early():
                pending.clear()
                break
            with timer.phase("drain"):
                if not drain_one():
                    spilled = True
        if not spilled:
            break
        # a group key fell outside its declared bound (outlier-resistant
        # IntInfo, or stats that grew after bind): redo the scan on the
        # unpacked sorted strategy, which has no static key bounds
        debug("key bound spilled; retrying on unpacked sorted strategy")
        bound.config = _dc.replace(bound.config, force_sorted=True,
                                   sort_pack=())
        pending.clear()
    if groups is None:
        return acc
    return {k: a for k, a in accs.items()
            if drained.get(k, 0) == n_batches.get(k)}


# -read-log's count of pseudo-blocks redone on the unpacked sorted
# strategy after a dense key spilled (reset by the caller)
ROWSTORE = {"sorted_retries": 0}


def _scan_rowstore(acc: "_Accumulator", ctx: _ScanCtx,
                   table: Table) -> None:
    """-read-log (the reference's engine.py:1598-1673, table_query.go:
    318-341): the undigested WAL records too.  The logs replay into
    columnar pseudo-blocks of one [1, C] row each, built on the query's
    device, and each goes through scan_packed unsharded (a mesh query's
    blocks went through the mesh; its config is the mesh's).  WAL rows
    are not covered by the digested blocks' exact statistics, so the
    scan strips every bound-derived specialisation (limb compression,
    value biasing, the lanes proven equal to samples, windowing, int32
    time) and packs the keyed table (no_compact_table: K3's keyed form of
    the scan's own table, the dense_keyed entry).  Strings found only in
    the WAL got dict ids during the replay: the filter literals, regex
    bitsets and str key bounds are re-resolved first, and a pseudo-block
    whose dense keys still spill (an int key or a time past the blocks'
    bounds) is redone, with every later one, on the unpacked sorted
    strategy."""
    import dataclasses as _dc

    import torch

    from .. import rowstore
    from ..digest import replay_logs_columnar
    from ..ops.scan import scan_packed

    bound, params, device = ctx.bound, ctx.params, ctx.device
    data, n = replay_logs_columnar(rowstore.list_logs(table.dir), table)
    if not n:
        return
    bound.refresh_str_filters()  # WAL-only strings got dict ids just now
    bound.refresh_key_bounds()
    ctx.refresh_consts()
    wal_cfg = _dc.replace(bound.config, lane_limbs8=(), agg_vbias=(),
                          lane_row_bounds=(), lane_nrows=(), window=0,
                          time_i32=False, no_compact_table=True)
    C = _pad_pow2(min(n, CHUNK_SIZE))
    tb = params.time_bucket or 1

    def on_device(a):
        return torch.from_numpy(a).to(device)

    for lo in range(0, n, C):
        hi = min(lo + C, n)
        cols, set_aux = {}, {}
        for name in bound.needed_cols:
            typ = bound.col_types[name]
            cd = data.get(name)
            if typ == SET_VAL:
                if isinstance(cd, blockio.SetColumnData):
                    offs = cd.offsets[lo: hi + 1] - cd.offsets[lo]
                    vals = cd.values[cd.offsets[lo]: cd.offsets[hi]]
                    rws = np.repeat(np.arange(hi - lo), np.diff(offs))
                else:
                    rws = vals = np.zeros(0, dtype=np.int64)
                prow, pval = pad_set_csr(rws, vals, C)
                set_aux[name] = (on_device(prow), on_device(pval), len(rws))
                continue
            values = np.zeros((1, C), dtype=np.int64)
            valid = np.zeros((1, C), dtype=bool)
            if isinstance(cd, blockio.IntColumnData):
                values[0, : hi - lo] = cd.values[lo:hi]
                valid[0, : hi - lo] = cd.valid[lo:hi]
            elif isinstance(cd, blockio.StrColumnData):
                values[0, : hi - lo] = cd.ids[lo:hi]
                valid[0, : hi - lo] = cd.valid[lo:hi]
            cols[name] = (on_device(values), on_device(valid))
        if not cols:
            cols["__count__"] = (on_device(np.zeros((1, C), np.int64)),
                                 on_device(np.ones((1, C), bool)))
        nrec = on_device(np.array([hi - lo], dtype=np.int32))
        packed, out = scan_packed(wal_cfg, cols, nrec, ctx.jfv, ctx.jbits,
                                  tb, set_aux)
        if acc.absorb_packed(packed, out, C, wal_cfg) > 0:
            # a key of the WAL's rows lies past its bind-time bound (an
            # int key or a time; str bounds were refreshed above): redo
            # this pseudo-block on the unpacked sorted strategy
            debug("row store: key bound spilled; retrying the pseudo-block "
                  "on the unpacked sorted strategy")
            wal_cfg = _dc.replace(wal_cfg, force_sorted=True, sort_pack=())
            packed, out = scan_packed(wal_cfg, cols, nrec, ctx.jfv,
                                      ctx.jbits, tb, set_aux)
            ROWSTORE["sorted_retries"] += 1
            acc.absorb_packed(packed, out, C, wal_cfg)


class _Accumulator:
    """Merges per-batch device partials into the reference result model."""

    def __init__(self, bound: BoundQuery):
        self.bound = bound
        self.params = bound.params
        # device->host download of a batch's packed buffer
        self.fetch = fetch_main
        # key tuple -> accumulated plain sums
        self.rows: dict[tuple, dict] = {}
        # columnar fast lane: simple-shape batches (no hist/distinct/
        # outlier/prune state) park their active rows as numpy arrays
        # and only materialize into `rows` dicts when a slow-path
        # consumer (cache save, cross-accumulator merge, pruning) needs
        # them; `finish` consumes them vectorized otherwise
        self.np_batches: list[tuple] = []
        self.matched_count = 0
        # device-pruned rows' count/sample sums (kept for Cumulative)
        self.cum_extra_count = 0
        self.cum_extra_samples = 0
        self.sample_rows: list[dict] = []
        self.batches = 0
        # intermediate top-k pruning (CombineAndPrune/PruneResults,
        # aggregate.go:347,469-471): cap at 10x limit, max 1000.  Like the
        # reference — which only prunes when the merge fan-in is large
        # (MultiCombineResults' >=4-specs-per-proc path) — pruning only
        # engages once more than one batch contributed, so single-batch
        # scans return exact results.
        p = bound.params
        self.prune_cap = 0
        if p.prune_by and p.limit > 0:
            self.prune_cap = min(p.limit * 10, 1000)

    # ------------------------------------------------------------------
    def _group_part(self, kt: tuple) -> tuple:
        return kt[1:] if self.params.time_bucket > 0 else kt

    def num_group_rows(self) -> int:
        """Distinct group count (the reference's len(Results), used by the
        distinct-limit early exit, table_query.go:263-279)."""
        self._materialize()
        if self.params.time_bucket > 0:
            return len({self._group_part(k) for k in self.rows})
        return len(self.rows)

    def distinct_limit_hit(self) -> bool:
        """distinct-limit early exit (table_query.go:263-279)."""
        return (self.params.num_distinct > 0
                and self.num_group_rows() >= self.params.num_distinct)

    def _materialize(self) -> None:
        """Fold parked columnar batches into the `rows` dict (slow-path
        consumers: merges, pruning, cache serialization)."""
        if not self.np_batches:
            return
        batches, self.np_batches = self.np_batches, []
        rows_map = self.rows
        for ak, counts, samples, aggs in batches:
            keys_l = ak.tolist()
            counts_l = counts.tolist()
            samples_l = samples.tolist()
            agg_l = [(np.asarray(ex).tolist(), cnt.tolist(), wv.tolist(),
                      mn.tolist(), mx.tolist())
                     for ex, cnt, wv, mn, mx in aggs]
            n_aggs = len(aggs)
            for i in range(len(keys_l)):
                kt = tuple(keys_l[i])
                row = rows_map.get(kt)
                if row is None:
                    row = {"count": 0, "samples": 0,
                           "aggs": [None] * n_aggs, "distinct": None}
                    rows_map[kt] = row
                row["count"] += counts_l[i]
                row["samples"] += samples_l[i]
                for ai in range(n_aggs):
                    ex, cnt, wv, mn_l, mx_l = agg_l[ai]
                    if not ex[i]:
                        continue
                    cur = row["aggs"][ai]
                    if cur is None:
                        cur = {"count": 0, "wv": 0, "min": None,
                               "max": None, "hist": None, "outliers": []}
                        row["aggs"][ai] = cur
                    cur["count"] += cnt[i]
                    cur["wv"] += wv[i]
                    if cnt[i] > 0:
                        mn, mx = mn_l[i], mx_l[i]
                        cur["min"] = (mn if cur["min"] is None
                                      else min(cur["min"], mn))
                        cur["max"] = (mx if cur["max"] is None
                                      else max(cur["max"], mx))

    def merge_from(self, other: "_Accumulator") -> None:
        """Merge another accumulator's rows (cached group partials or a
        scoped sub-scan) into this one.  Parked columnar batches move
        over WITHOUT materializing — `finish` folds them vectorized, so
        merging N cache-group hits stays columnar end to end."""
        self.np_batches.extend(other.np_batches)
        other.np_batches = []
        self.matched_count += other.matched_count
        self.cum_extra_count += other.cum_extra_count
        self.cum_extra_samples += other.cum_extra_samples
        self.batches += other.batches
        for kt, row in other.rows.items():
            mine = self.rows.get(kt)
            if mine is None:
                self.rows[kt] = row
                continue
            mine["count"] += row["count"]
            mine["samples"] += row["samples"]
            for ai, cur in enumerate(row["aggs"]):
                if cur is None:
                    continue
                m = mine["aggs"][ai]
                if m is None:
                    mine["aggs"][ai] = cur
                    continue
                m["count"] += cur["count"]
                m["wv"] += cur["wv"]
                if cur["min"] is not None:
                    m["min"] = (cur["min"] if m["min"] is None
                                else min(m["min"], cur["min"]))
                if cur["max"] is not None:
                    m["max"] = (cur["max"] if m["max"] is None
                                else max(m["max"], cur["max"]))
                if cur["hist"] is not None:
                    m["hist"] = (cur["hist"] if m["hist"] is None
                                 else m["hist"] + cur["hist"])
                if cur.get("td") is not None:
                    if m.get("td") is None:
                        m["td"] = cur["td"]
                    else:
                        m["td"].merge(cur["td"])
                m["outliers"].extend(cur["outliers"])
            if row["distinct"] is not None:
                if mine["distinct"] is None:
                    mine["distinct"] = row["distinct"]
                else:
                    mine["distinct"].merge(row["distinct"])

    def _prune_score(self, rows_of_group: list[dict]):
        p = self.params
        if p.prune_by == SORT_COUNT or not p.prune_by:
            return sum(r["count"] for r in rows_of_group)
        # hist mean of the prune column (SortResultsByCol semantics)
        for ai, a in enumerate(p.aggs):
            if a.col == p.prune_by:
                cnt = sum(r["aggs"][ai]["count"] for r in rows_of_group
                          if r["aggs"][ai] is not None)
                wv = sum(r["aggs"][ai]["wv"] for r in rows_of_group
                         if r["aggs"][ai] is not None)
                return wv / cnt if cnt else 0.0
        return 0.0

    def maybe_prune(self) -> None:
        """Intermediate prune between batch merges: keep the top
        prune_cap groups by the prune metric, drop the rest.  Dropped
        rows' count/sample sums are banked for the Cumulative row — the
        reference merges into Cumulative BEFORE PruneResults drops rows
        (aggregate.go:422-471) — but their per-group identity is lost,
        the same approximation the reference makes."""
        if not self.prune_cap or self.batches < 2:
            return
        self._materialize()
        if self.num_group_rows() <= self.prune_cap:
            return
        by_group: dict[tuple, list] = {}
        for kt, row in self.rows.items():
            by_group.setdefault(self._group_part(kt), []).append(row)
        ranked = sorted(by_group, key=lambda g: self._prune_score(by_group[g]),
                        reverse=True)
        keep = set(ranked[: self.prune_cap])
        kept_rows = {}
        for kt, row in self.rows.items():
            if self._group_part(kt) in keep:
                kept_rows[kt] = row
            else:
                self.cum_extra_count += row["count"]
                self.cum_extra_samples += row["samples"]
        self.rows = kept_rows


    def absorb_packed(self, packed, out, R: int, config=None) -> int:
        """Parse the single packed download (ops/scan.py scan_packed):
        row 0 meta [num_groups, spill, nout per hist agg, npairs, the mesh
        shuffle's overflow (refused), pruned, total count, total samples
        (the last two 0
        unless pruned), nhistpairs per hist agg]; then the group
        table (the dense compact keyless form, or the keyed prefix of the
        sorted strategy); then per-hist-agg compacted outlier rows; then
        the dense hist gids and bucket matrices, or the sorted strategy's
        sparse hist pairs.  The device outputs (`out`, and the sorted
        strategy's full table in packed["table"]) are touched only when
        the meta row reports that a packed section overflowed.  Returns
        the spill count (>0 => this batch's rows were NOT absorbed)."""
        from ..ops.scan import (HLL_M, SENTINEL, dense_keys_np,
                                dense_table_plan, fetch_hist_pairs,
                                fetch_hist_rows, fetch_hll, fetch_outliers,
                                fetch_pairs, fetch_table, hist_aggs,
                                packed_layout, table_prefix)
        if config is None:
            config = self.bound.config
        dense = config.strategy == "dense"
        p = self.params
        main = self.fetch(packed)  # the one download
        layout = packed_layout(config, R)
        K = config.n_key_cols
        S = config.table_slots
        P = table_prefix(config)

        def section_flat(name: str, count: int) -> np.ndarray:
            off, rows = layout[name]
            return main[off: off + rows].reshape(-1)[:count]

        hist_ais = hist_aggs(config)
        meta = main[0]
        num_groups = int(meta[0])
        spill = int(meta[1])
        if spill > 0:
            return spill
        nouts = {ai: int(meta[2 + i]) for i, ai in enumerate(hist_ais)}
        npairs = int(meta[2 + len(hist_ais)])
        overflow = int(meta[3 + len(hist_ais)])
        if overflow > 0:
            # a mesh scan's shuffle capacity exceeded (extreme key-hash
            # clustering, or more merged groups than table slots): refuse
            # a silently truncated result (reference engine.py:1899-1904)
            error("sharded shuffle overflowed by", overflow,
                  "group rows; raise -max-groups or use fewer data shards")
        # device prune (prune_topk): the marker, then the whole batch's
        # count and sample totals
        pi = 4 + len(hist_ais)
        pruned = int(meta[pi]) if pi < main.shape[1] else 0
        if pruned:
            total_count, total_samples = int(meta[pi + 1]), int(meta[pi + 2])
        nhps = {ai: int(meta[7 + len(hist_ais) + i])
                for i, ai in enumerate(hist_ais)}
        if num_groups > config.max_groups and not pruned:
            warn("group cap", config.max_groups,
                 "exceeded; highest-keyed groups dropped")

        plan = dense_table_plan(config, R)
        if plan is not None:
            # compact dense table: no key columns (slots are arithmetic,
            # decoded host-side), int32 pair packing when bounds allow
            wpr = layout["table_wpr"]
            words = section_flat("table", P * wpr).reshape(P, wpr)
            nc = len(plan["cols"])
            npack = -(-nc // 2) if plan["i32"] else nc
            if plan["i32"]:
                a32 = np.ascontiguousarray(
                    words[:, :npack]).view("<i4").reshape(P, npack * 2)
                colmap = {nme: a32[:, j].astype(np.int64)
                          for j, nme in enumerate(plan["cols"])}
            else:
                colmap = {nme: words[:, j]
                          for j, nme in enumerate(plan["cols"])}
            for j, nme in enumerate(plan["i64_cols"]):
                colmap[nme] = words[:, npack + j]
            keys = dense_keys_np(config, p.time_bucket or 1)
            samples = colmap["samples"]
            # lanes proven equal to samples were elided from the wire
            # (dense_table_plan lane_nrows skip); rebuild them here
            counts = colmap.get("count", samples)
        else:
            if dense:
                n = P
            elif pruned:
                # the device already top-k'd the table: only the best
                # rows were shipped
                n = min(num_groups, pruned)
            else:
                n = min(num_groups, S)
            # the sorted strategy's live groups past the prefix: fetch the
            # table's first n rows from the device (escalation)
            table = fetch_table(packed, n) if n > P else main[1: 1 + n]
            keys = table[:, :K]
            counts = table[:, K]
            samples = table[:, K + 1]
        active = np.nonzero((samples != 0) | (counts != 0))[0]
        if pruned:
            # kept rows undercount: use the device-side totals, and bank
            # the dropped rows' sums for the Cumulative row (the
            # reference's Cumulative keeps pruned rows' counts,
            # aggregate.go:422-471)
            self.matched_count += total_samples
            self.cum_extra_count += total_count - int(counts[active].sum())
            self.cum_extra_samples += (total_samples
                                       - int(samples[active].sum()))
        else:
            self.matched_count += int(samples[active].sum())

        if hist_ais and dense:
            Ph = layout["Ph"]
            hists_small = {
                ai: section_flat(f"hist{ai}",
                                 Ph * config.aggs[ai].num_values)
                .reshape(Ph, config.aggs[ai].num_values)
                for ai in hist_ais}
            gids = section_flat("hist_gids", Ph)
            hist_row_of = {int(g): i for i, g in enumerate(gids)}

        aggdata = []
        vbias = config.agg_vbias or ()
        sent_mn = sent_mx = None
        for ai in range(len(self.bound.agg_layouts)):
            if plan is not None:
                acnt = colmap.get(f"agg{ai}_count", samples)
                wv = colmap[f"agg{ai}_wv"]
                if ai < len(vbias) and vbias[ai]:
                    # the device summed kw*(v-bias); add bias*Σkw back
                    wv = wv + vbias[ai] * acnt
                if f"agg{ai}_min" not in colmap:
                    # avg-op aggs never ship min/max (empty-slot
                    # sentinels, as in the reference's wire format)
                    if sent_mn is None:
                        sent_mn = np.full(P, 2**62, dtype=np.int64)
                        sent_mx = np.full(P, -2**62, dtype=np.int64)
                d = {
                    "exists": colmap.get(f"agg{ai}_exists", samples) != 0,
                    "count": acnt,
                    "wv": wv,
                    "min": colmap.get(f"agg{ai}_min", sent_mn),
                    "max": colmap.get(f"agg{ai}_max", sent_mx),
                }
            else:
                base = K + 2 + 5 * ai
                wv = table[:, base + 2]
                if ai < len(vbias) and vbias[ai]:
                    # the device summed kw*(v-bias); add bias*Σkw back
                    wv = wv + vbias[ai] * table[:, base + 1]
                d = {
                    "exists": table[:, base] != 0,
                    "count": table[:, base + 1],
                    "wv": wv,
                    "min": table[:, base + 3],
                    "max": table[:, base + 4],
                }
            if ai in nouts and dense:  # dense hist agg: bucket matrix
                if num_groups > layout["Ph"]:
                    # actives overflow the compaction: gather ONLY the
                    # active slots' bucket rows on device (never the
                    # full [Sc, nv] matrix) before fetching
                    hact = fetch_hist_rows(out, ai, active)
                    pos = {int(g): i for i, g in enumerate(active)}
                    d["hist_get"] = lambda gi, h=hact, m=pos: h[m[gi]]
                else:
                    hsmall = hists_small[ai]
                    d["hist_get"] = (
                        lambda gi, h=hsmall, m=hist_row_of:
                        h[m[gi]] if gi in m else None)
            if ai in nouts and nouts[ai] > 0:  # outlier fix-up rows
                kmax = layout["kmax_out"]
                off = layout[f"out{ai}"][0]
                block = main[off: off + kmax]
                if nouts[ai] > kmax:  # escalate to the full arrays
                    d["outlier_pairs"] = fetch_outliers(config, out, ai)
                else:
                    flags_col = block[:, K + 1] != 0
                    d["outlier_pairs"] = (block[flags_col, :K],
                                          block[flags_col, K])
            aggdata.append(d)

        # columnar fast lane: simple shapes park the active rows as
        # numpy arrays; `finish` consumes them vectorized, skipping the
        # per-row dict churn entirely.  A prune_cap does NOT exclude
        # parking: maybe_prune materializes on demand, and it only ever
        # acts from the second batch on.  A device-pruned batch is not
        # parked, as the reference's is not.
        if (not p.distincts and not hist_ais and not pruned
                and p.num_distinct <= 0 and not config.track_outliers):
            sel = active
            ak = keys[sel]
            if K and len(sel):
                m = ak[:, 0] != SENTINEL
                if not m.all():
                    sel = sel[m]
                    ak = ak[m]
            self.np_batches.append((
                ak, counts[sel], samples[sel],
                [(d["exists"][sel], d["count"][sel], d["wv"][sel],
                  d["min"][sel], d["max"][sel]) for d in aggdata]))
            self.batches += 1
            return 0

        # bulk-convert the active rows to plain Python once: per-element
        # `int(np_scalar)` in the loop below costs ~200ns a pop
        self._materialize()
        active_l = active.tolist()
        keys_l = keys[active].tolist()
        counts_l = counts[active].tolist()
        samples_l = samples[active].tolist()
        agg_l = [(d["exists"][active].tolist(), d["count"][active].tolist(),
                  d["wv"][active].tolist(), d["min"][active].tolist(),
                  d["max"][active].tolist()) for d in aggdata]
        rows_map = self.rows
        for i, gi in enumerate(active_l):
            kt = tuple(keys_l[i])
            if kt and kt[0] == SENTINEL:
                continue
            row = rows_map.get(kt)
            if row is None:
                row = {"count": 0, "samples": 0,
                       "aggs": [None] * len(aggdata), "distinct": None}
                rows_map[kt] = row
            row["count"] += counts_l[i]
            row["samples"] += samples_l[i]
            for ai, d in enumerate(aggdata):
                ex, cnt, wv, mn_l, mx_l = agg_l[ai]
                if not ex[i]:
                    continue
                cur = row["aggs"][ai]
                if cur is None:
                    cur = {"count": 0, "wv": 0, "min": None, "max": None,
                           "hist": None, "outliers": []}
                    row["aggs"][ai] = cur
                cur["count"] += cnt[i]
                cur["wv"] += wv[i]
                if cnt[i] > 0:
                    mn, mx = mn_l[i], mx_l[i]
                    cur["min"] = mn if cur["min"] is None else min(cur["min"], mn)
                    cur["max"] = mx if cur["max"] is None else max(cur["max"], mx)
                if "hist_get" in d:
                    h = d["hist_get"](gi)
                    if h is not None:
                        cur["hist"] = (h if cur["hist"] is None
                                       else cur["hist"] + h)

        for ai, d in enumerate(aggdata):
            if "outlier_pairs" not in d:
                continue
            gk, ov = d["outlier_pairs"]
            for krow, v in zip(gk, ov):
                row = self.rows.get(tuple(int(k) for k in krow))
                if row is not None and row["aggs"][ai] is not None:
                    row["aggs"][ai]["outliers"].append(int(v))

        if hist_ais and not dense:
            # the sorted strategy ships sparse (group keys, bucket, Σw)
            # rows instead of bucket matrices
            for ai in hist_ais:
                if nhps[ai] == 0:
                    continue
                if nhps[ai] > layout["Hcap"]:   # escalate to full arrays
                    hkeys, hbv, hw = fetch_hist_pairs(out, ai)
                else:
                    off, rows = layout[f"hpair{ai}"]
                    block = main[off: off + rows]
                    hvalid = block[:, K + 2] != 0
                    hkeys = block[hvalid, :K]
                    hbv = block[hvalid, K]
                    hw = block[hvalid, K + 1]
                self._absorb_hist_pairs(ai, hkeys, hbv, hw,
                                        config.aggs[ai])

        if p.distincts and npairs > 0:
            # the sorted strategy's (group, distinct) pairs
            if npairs > layout["kmax_pairs"]:   # escalate to the device
                skeys = fetch_pairs(out)
            else:
                off, rows = layout["pairs"]
                block = main[off: off + rows]
                nkall = config.n_all_keys
                skeys = block[block[:, nkall] != 0, :nkall]
            self._absorb_distinct(skeys, K)
        elif p.distincts and config.hll and dense and len(active):
            # the device HLL: merge the shipped register planes by max
            Phll = layout["Phll"]
            gids_h = section_flat("hll_gids", Phll).astype(np.int64)
            words = section_flat("hll_regs", Phll * (HLL_M // 8))
            regs = np.ascontiguousarray(
                words.astype("<i8")).view(np.uint8).reshape(Phll, HLL_M)
            row_of = {int(g): i for i, g in enumerate(gids_h.tolist())}
            # live groups past the shipped planes: fetch them all
            full = fetch_hll(out) if len(active) > Phll else None
            for i, gi in enumerate(active_l):
                if full is not None:
                    plane = full[gi]
                else:
                    hr = row_of.get(gi)
                    if hr is None:
                        continue
                    plane = regs[hr]
                row = self.rows.get(tuple(keys_l[i]))
                if row is None:
                    continue
                if row["distinct"] is None:
                    row["distinct"] = HLL()
                np.maximum(row["distinct"].registers, plane,
                           out=row["distinct"].registers)
        self.batches += 1
        return 0

    def _absorb_distinct(self, skeys: np.ndarray, nkeys: int) -> None:
        """Feed each (group keys, distinct values) pair into its group's
        host HLL (reference engine.py:2267-2297): the int fast path's
        8-byte little-endian packing (MISSING = MaxUint64), or the
        display strings joined by GROUP_DELIMITER.  SENTINEL rows are
        unmatched and skipped."""
        from ..ops.scan import SENTINEL
        p = self.params
        int_only = all(self.bound.col_types[d] == INT_VAL
                       for d in p.distincts)
        for rowkeys in skeys:
            kt = tuple(int(k) for k in rowkeys[:nkeys])
            if kt and kt[0] == SENTINEL:
                continue
            row = self.rows.get(kt)
            if row is None:
                continue
            if row["distinct"] is None:
                row["distinct"] = HLL()
            dvals = rowkeys[nkeys:]
            if int_only:
                buf = b"".join((int(v) & MISSING_VALUE).to_bytes(8, "little")
                               for v in dvals)
            else:
                parts = []
                for d, v in zip(p.distincts, dvals):
                    if int(v) == MISSING_I64:
                        parts.append("")
                    elif self.bound.col_types[d] == STR_VAL:
                        parts.append(self.bound._strings(d)[int(v)])
                    else:
                        parts.append(str(int(v)))
                buf = (GROUP_DELIMITER.join(parts) + GROUP_DELIMITER).encode()
            row["distinct"].add(buf)

    def _absorb_hist_pairs(self, ai: int, hkeys: np.ndarray,
                           hbv: np.ndarray, hw: np.ndarray, spec) -> None:
        """Merge sparse (group keys, bucket, Σw) hist rows into the group
        table (reference engine.py:2208-2265): one np.add.at builds a
        [unique groups, nv] delta added per group, or, for -tdigest, the
        pairs' exact values feed each group's t-digest."""
        if hkeys.shape[0] == 0:
            return
        _, _, hist_type = self.bound.agg_layouts[ai]
        nv = spec.num_values
        ukeys, inv = np.unique(hkeys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        if hist_type == "tdigest":
            from .hist import TDigest
            vals = spec.hist_min + np.asarray(hbv, dtype=np.int64) \
                * spec.bucket_size
            order = np.argsort(inv, kind="stable")
            sinv = inv[order]
            starts = np.searchsorted(sinv, np.arange(ukeys.shape[0]))
            ends = np.append(starts[1:], sinv.size)
            svals, sws = vals[order], np.asarray(hw)[order]
            for u, krow in enumerate(ukeys.tolist()):
                row = self.rows.get(tuple(krow))
                if row is None or row["aggs"][ai] is None:
                    continue
                cur = row["aggs"][ai]
                td = cur.get("td")
                if td is None:
                    td = cur["td"] = TDigest()
                td.add_many(svals[starts[u]:ends[u]],
                            sws[starts[u]:ends[u]])
            return
        U = ukeys.shape[0]
        if U * nv <= 64_000_000:
            delta = np.zeros((U, nv), dtype=np.int64)
            np.add.at(delta, (inv, hbv.astype(np.int64)), hw)
            for u, krow in enumerate(ukeys.tolist()):
                row = self.rows.get(tuple(krow))
                if row is None or row["aggs"][ai] is None:
                    continue
                cur = row["aggs"][ai]
                cur["hist"] = (delta[u].copy() if cur["hist"] is None
                               else cur["hist"] + delta[u])
        else:  # a huge group count times a huge bucket count
            for krow, b, w in zip(hkeys.tolist(), hbv.tolist(),
                                  hw.tolist()):
                row = self.rows.get(tuple(krow))
                if row is None or row["aggs"][ai] is None:
                    continue
                cur = row["aggs"][ai]
                if cur["hist"] is None:
                    cur["hist"] = np.zeros(nv, dtype=np.int64)
                cur["hist"][int(b)] += int(w)

    def collect_samples(self, out, batch_dirs, nrec, C) -> None:
        """Up to 4 * limit sample rows, each {column: value} of a matched
        row, in block order: the batch's matched mask (raw["matched"])
        picks the rows, read back from the blocks' host-decoded columns
        (all columns, or -sample-cols' subset), as the reference's
        collect_samples (engine.py:2299-2334)."""
        matched = out["matched"].cpu().numpy()
        limit = max(self.params.limit, 1)
        schema = self.bound.table.schema
        if self.params.sample_cols:
            # -sample-cols loads only the requested columns
            # (cmd_query.go:142-146,196)
            all_cols = [c for c in self.params.sample_cols
                        if c in schema.key_table]
        else:
            all_cols = sorted(schema.key_table)
        for bi, bdir in enumerate(batch_dirs):
            if len(self.sample_rows) >= limit * 4 or nrec[bi] == 0:
                continue
            rows = np.nonzero(matched[bi, :nrec[bi]])[0]
            if not len(rows):
                continue
            data = blockio.load_block_columns(bdir, schema, all_cols)
            for r in rows[: limit * 4 - len(self.sample_rows)]:
                sample = {}
                for name, cd in data.items():
                    if isinstance(cd, blockio.IntColumnData):
                        if cd.valid[r]:
                            sample[name] = int(cd.values[r])
                    elif isinstance(cd, blockio.StrColumnData):
                        if cd.valid[r]:
                            sample[name] = self.bound._strings(name)[
                                int(cd.ids[r])]
                    else:
                        lo, hi = int(cd.offsets[r]), int(cd.offsets[r + 1])
                        if hi > lo:
                            strs = self.bound._strings(name)
                            sample[name] = [strs[int(v)]
                                            for v in cd.values[lo:hi]]
                self.sample_rows.append(sample)

    def finish(self) -> QueryResults:
        p = self.params
        bound = self.bound
        qr = QueryResults()
        qr.matched_count = self.matched_count
        qr.samples = self.sample_rows

        if self.np_batches and not self.rows:
            self._finish_fast(qr)
            self._sort(qr)
            return qr
        self._materialize()

        time_mode = p.time_bucket > 0
        group_slice = slice(1, None) if time_mode else slice(None)

        per_time: dict[int, dict[str, Result]] = {}
        flat: dict[str, Result] = {}
        for kt, row in self.rows.items():
            res = self._make_result(kt[group_slice], row)
            if time_mode:
                tb = kt[0]
                bucket = per_time.setdefault(tb, {})
                prev = bucket.get(res.group_key)
                if prev is None:
                    bucket[res.group_key] = res
                else:
                    prev.combine(res)
                # per-group totals live in Results (aggregate.go:156-169)
                tot = flat.get(res.group_key)
                if tot is None:
                    tot = Result()
                    tot.group_key = res.group_key
                    tot.key_tuple = res.key_tuple
                    flat[res.group_key] = tot
                tot.count += res.count
                tot.samples += res.samples
            else:
                prev = flat.get(res.group_key)
                if prev is None:
                    flat[res.group_key] = res
                else:
                    # str-replace collisions overwrite in the reference's
                    # translate_group_by map; counts merge here instead
                    prev.combine(res)

        qr.results = flat
        qr.time_results = per_time

        # Cumulative row (aggregate.go:422-428,434-436)
        cumulative = Result()
        cumulative.group_key = "TOTAL"
        if len(p.groups) > 1:
            cumulative.group_key += GROUP_DELIMITER * (len(p.groups) - 1)
        for res in flat.values():
            cumulative.combine(res)
        # rows the device prune dropped still count toward the total
        cumulative.count += self.cum_extra_count
        cumulative.samples += self.cum_extra_samples
        qr.cumulative = cumulative

        self._sort(qr)
        return qr

    def _finish_fast(self, qr: QueryResults) -> None:
        """Vectorized finish over the parked columnar batches (simple
        shapes only — see the absorb fast gate).  Semantics identical to
        the dict path: same display keys, same combine-on-collision for
        -str-replace, same Cumulative math."""
        p = self.params
        bound = self.bound
        batches, self.np_batches = self.np_batches, []
        SENT = 2**62
        if len(batches) == 1:
            ak, counts, samples, aggs = batches[0]
        else:
            ak0 = np.concatenate([b[0] for b in batches])
            counts0 = np.concatenate([b[1] for b in batches])
            samples0 = np.concatenate([b[2] for b in batches])
            ak, inv = np.unique(ak0, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            U = ak.shape[0]
            counts = np.zeros(U, np.int64)
            np.add.at(counts, inv, counts0)
            samples = np.zeros(U, np.int64)
            np.add.at(samples, inv, samples0)
            aggs = []
            for ai in range(len(batches[0][3])):
                ex0 = np.concatenate(
                    [np.asarray(b[3][ai][0], dtype=np.int64)
                     for b in batches])
                cnt0 = np.concatenate([b[3][ai][1] for b in batches])
                wv0 = np.concatenate([b[3][ai][2] for b in batches])
                mn0 = np.concatenate([b[3][ai][3] for b in batches])
                mx0 = np.concatenate([b[3][ai][4] for b in batches])
                ex = np.zeros(U, np.int64)
                np.add.at(ex, inv, ex0)
                cnt = np.zeros(U, np.int64)
                np.add.at(cnt, inv, cnt0)
                wv = np.zeros(U, np.int64)
                np.add.at(wv, inv, wv0)
                mn = np.full(U, SENT, np.int64)
                np.minimum.at(mn, inv, np.where(cnt0 > 0, mn0, SENT))
                mx = np.full(U, -SENT, np.int64)
                np.maximum.at(mx, inv, np.where(cnt0 > 0, mx0, -SENT))
                aggs.append((ex, cnt, wv, mn, mx))

        time_mode = p.time_bucket > 0
        str_cols = [bound._strings(c)
                    if bound.col_types[c] == STR_VAL else None
                    for c in p.groups]
        infos = [(a.col, lay[0]) for a, lay in
                 zip(p.aggs, bound.agg_layouts)]
        G = GROUP_DELIMITER

        def gk_of(gkt: tuple) -> str:
            if not p.groups:
                return "total"
            parts = []
            for ci, v in enumerate(gkt):
                if v == MISSING_I64:
                    parts.append("")
                else:
                    ss = str_cols[ci]
                    if ss is None:
                        parts.append(str(v))
                    else:
                        parts.append(ss[v] if 0 <= v < len(ss) else "")
                parts.append(G)
            return "".join(parts)

        counts_l = counts.tolist()
        samples_l = samples.tolist()
        aggs_l = [(np.asarray(ex).tolist(), cnt.tolist(), wv.tolist(),
                   mn.tolist(), mx.tolist())
                  for (ex, cnt, wv, mn, mx) in aggs]

        if time_mode:
            # rollups produce thousands of (bucket, group) rows whose
            # Result objects the reference builds eagerly
            # (aggregate.go:146-169); here only the few per-GROUP
            # totals are built now — the per-bucket explosion parks on
            # qr and runs lazily on first time_results access
            gpart = ak[:, 1:]
            if gpart.shape[1]:
                uniq, inv = np.unique(gpart, axis=0, return_inverse=True)
            else:
                uniq = np.zeros((1, 0), np.int64)
                inv = np.zeros(len(ak), np.int64)
            inv = inv.reshape(-1)
            U = uniq.shape[0]
            key_tuples = [tuple(t) for t in uniq.tolist()]
            ugks = [gk_of(t) for t in key_tuples]
            csum = np.zeros(U, np.int64)
            np.add.at(csum, inv, counts)
            ssum = np.zeros(U, np.int64)
            np.add.at(ssum, inv, samples)
            flat: dict[str, Result] = {}
            for j in range(U):
                tot = flat.get(ugks[j])
                if tot is None:
                    tot = Result()
                    tot.group_key = ugks[j]
                    tot.key_tuple = key_tuples[j]
                    flat[ugks[j]] = tot
                tot.count += int(csum[j])
                tot.samples += int(ssum[j])
            inv_l = inv.tolist()
            gks = [ugks[j] for j in inv_l]
            row_kts = [key_tuples[j] for j in inv_l]
            agg_rows = [(col, info, *aggs_l[ai])
                        for ai, (col, info) in enumerate(infos)]
            qr.results = flat
            qr.time_results = {}
            qr._time_pending = (ak[:, 0].tolist(), gks, row_kts,
                                counts_l, samples_l, agg_rows)
        else:
            keys_l = ak.tolist()
            flat = {}
            gk_memo: dict[tuple, str] = {}
            for i in range(len(keys_l)):
                gkt = tuple(keys_l[i])
                gk = gk_memo.get(gkt)
                if gk is None:
                    gk = gk_memo[gkt] = gk_of(gkt)
                res = Result()
                res.key_tuple = gkt
                res.group_key = gk
                res.count = counts_l[i]
                res.samples = samples_l[i]
                for ai, (col, info) in enumerate(infos):
                    ex, cnt, wv, mn, mx = aggs_l[ai]
                    if not ex[i]:
                        continue
                    c = cnt[i]
                    res.hists[col] = BasicHist.from_sums(
                        info.min, info.max, c, wv[i],
                        mn[i] if c > 0 else SENT,
                        mx[i] if c > 0 else -SENT)
                prev = flat.get(gk)
                if prev is None:
                    flat[gk] = res
                else:
                    prev.combine(res)
            qr.results = flat
            qr.time_results = {}
        cumulative = Result()
        cumulative.group_key = "TOTAL"
        if len(p.groups) > 1:
            cumulative.group_key += GROUP_DELIMITER * (len(p.groups) - 1)
        for res in flat.values():
            cumulative.combine(res)
        cumulative.count += self.cum_extra_count
        cumulative.samples += self.cum_extra_samples
        qr.cumulative = cumulative

    def _make_result(self, key_tuple: tuple, row: dict) -> Result:
        p = self.params
        bound = self.bound
        res = Result()
        res.key_tuple = key_tuple
        res.count = row["count"]
        res.samples = row["samples"]
        res.distinct = row["distinct"]

        parts = []
        if not p.groups:
            parts.append("total")
        else:
            for col, v in zip(p.groups, key_tuple):
                if v == MISSING_I64:
                    parts.append("")
                elif bound.col_types[col] == STR_VAL:
                    strings = bound._strings(col)
                    parts.append(strings[v] if 0 <= v < len(strings) else "")
                else:
                    parts.append(str(v))
                parts.append(GROUP_DELIMITER)
        res.group_key = "".join(parts)

        for (adef, (info, want_hist, hist_type), cur) in zip(
                p.aggs, bound.agg_layouts, row["aggs"]):
            if cur is None:
                continue
            if want_hist and hist_type == "tdigest":
                from .hist import TDigestHist
                h = TDigestHist(info.min, info.max, p.hist_bucket)
                h.load_device_partial(
                    cur["count"], cur["wv"],
                    outlier_values=cur["outliers"])
                if cur.get("td") is not None:
                    h.td.merge(cur["td"])
                res.hists[adef.col] = h
                continue
            if not want_hist and not cur["outliers"] and \
                    cur.get("hist") is None and cur["min"] is not None:
                # plain-avg hot path: one hist per group row; skip the
                # bucket-layout init entirely (many-group rollups build
                # thousands of these per query)
                res.hists[adef.col] = BasicHist.from_sums(
                    info.min, info.max, cur["count"], cur["wv"],
                    cur["min"], cur["max"])
                continue
            cls = MultiHist if (want_hist and hist_type == "multi") else BasicHist
            h = cls(info.min, info.max, p.hist_bucket, percentile_mode=want_hist)
            h.load_device_partial(
                cur["count"], cur["wv"], cur.get("hist"),
                outlier_values=cur["outliers"],
                vmin=cur["min"], vmax=cur["max"])
            res.hists[adef.col] = h
        return res

    def _sort(self, qr: QueryResults) -> None:
        sort_results(qr, self.params)


def sort_results(qr: QueryResults, params: QueryParams) -> None:
    """SortResults port (aggregate.go:497-525): by Count or hist mean,
    descending by default."""
    if not params.order_by:
        return

    def sort_key(r: Result):
        if params.order_by == SORT_COUNT:
            return r.count
        h = r.hists.get(params.order_by)
        return h.mean() if h else 0.0

    qr.sorted = sorted(qr.results.values(), key=sort_key, reverse=True)
    if params.order_asc:
        qr.sorted.reverse()
