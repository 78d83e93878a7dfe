"""Table object: metadata lifecycle, block listing, ingestion entry points.

Mirrors the reference Table (src/lib/table.go, table_io.go, table_ingest.go):
- info.json is the schema + table-level stats, saved with a .bak checkpoint
  under the info lock (table_io.go:26-66)
- ingest appends typed records to the WAL then auto-digests past the
  file-count/byte thresholds (table_ingest.go:33-82)
- blocks are subdirectories named block*; the row store lives in ingest/
"""

from __future__ import annotations

import os
import uuid

import numpy as np

from . import blocks, codec, constants, rowstore
from .config import Flags
from .debug import debug, warn
from .dicts import DictStore
from .ingest import update_schema_stats
from .locks import BlockLock, DigestLock, InfoLock
from .schema import Schema


class Table:
    def __init__(self, name: str, flags: Flags | None = None):
        self.flags = flags or Flags()
        self.name = name
        self.dir = os.path.join(self.flags.dir, name)
        self.schema = Schema()
        self.dicts = DictStore(self.dir)
        self._info_loaded = False

    # ------------------------------------------------------------------
    # info lifecycle
    # ------------------------------------------------------------------
    @property
    def info_path(self) -> str:
        return os.path.join(self.dir, "info.json")

    def exists(self) -> bool:
        return os.path.exists(self.info_path) or os.path.exists(self.info_path + ".bak")

    def _load_info_nolock(self) -> bool:
        try:
            data = codec.read_json(self.info_path)
        except FileNotFoundError:
            return False
        except ValueError:
            # torn/corrupt info.json: fall back to the .bak checkpoint
            # (the reference restores from .bak, table_lock.go:51-76)
            try:
                data = codec.read_json(self.info_path + ".bak")
            except (FileNotFoundError, ValueError):
                return False
        self.schema = Schema.from_json(data.get("schema", {}))
        self._info_loaded = True
        return True

    def _save_info_nolock(self) -> None:
        codec.write_json_atomic(self.info_path,
                                {"name": self.name,
                                 "schema": self.schema.to_json(),
                                 "version": constants.VERSION},
                                backup=True)

    def load_info(self) -> bool:
        with InfoLock(self.dir):
            return self._load_info_nolock()

    def save_info(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with InfoLock(self.dir):
            self._save_info_nolock()

    def update_info(self, mutate) -> None:
        """Read-modify-write the table info under ONE InfoLock session:
        load the freshest on-disk schema, apply `mutate(schema)`, save.
        Every cross-process schema mutation (new key ids, type claims,
        stat updates) must go through here — separate load_info() /
        save_info() calls let two first-ingesters assign the same key id
        to different columns (block stats are keyed by id)."""
        os.makedirs(self.dir, exist_ok=True)
        with InfoLock(self.dir):
            self._load_info_nolock()
            mutate(self.schema)
            self._save_info_nolock()

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def list_block_dirs(self) -> list[str]:
        if not os.path.isdir(self.dir):
            return []
        out = []
        for entry in sorted(os.listdir(self.dir)):
            if not entry.startswith(constants.BLOCK_PREFIX):
                continue
            if entry.endswith((".partial", ".old", ".broke", ".lock")):
                continue
            p = os.path.join(self.dir, entry)
            if os.path.isdir(p):
                out.append(p)
        return out

    def new_block_name(self) -> str:
        # creation-time-prefixed so names sort in append order: new blocks
        # append AFTER all existing ones, keeping the query cache's stable
        # block groups stable under a steady ingest stream (query/cache.py)
        import time
        return (f"{constants.BLOCK_PREFIX}{time.time_ns():016x}"
                f"{uuid.uuid4().hex[:8]}")

    def block_infos(self) -> dict[str, blocks.BlockInfo]:
        """Per-block info, via the batched block-info cache when enabled
        (table_io.go:242-368): full blocks are immutable, so their infos
        are read once and served from cache/blocks_*.json.gz; partial
        blocks are always re-read."""
        from . import blockcache
        from .constants import CHUNK_SIZE
        cached = (blockcache.load(self.dir)
                  if self.flags.cache_block_infos else {})
        out = {}
        fresh: dict[str, blocks.BlockInfo] = {}
        for bdir in self.list_block_dirs():
            name = os.path.basename(bdir)
            info = cached.get(name)
            if info is None:
                info = blocks.load_block_info(bdir)
                if (info is not None and self.flags.cache_block_infos
                        and info.num_records >= CHUNK_SIZE):
                    fresh[name] = info
            if info is not None:
                out[bdir] = info
        if fresh:
            blockcache.append(self.dir, fresh)
        return out

    def record_count(self) -> int:
        return sum(i.num_records for i in self.block_infos().values())

    # ------------------------------------------------------------------
    # ingestion (table_ingest.go:33-82)
    # ------------------------------------------------------------------
    def ingest_records(self, records: list[dict]) -> None:
        """Append typed records ({"i","s","e"} dicts) to the WAL."""
        if not records:
            return
        os.makedirs(self.dir, exist_ok=True)
        # schema first, WAL second: digestion drops columns whose type is
        # missing from the schema, so the type claims must be durable
        # before the records become digestible
        self.update_info(lambda schema: update_schema_stats(
            schema, records, self.flags.skip_outliers))
        rowstore.append_records_to_log(self.dir, records)
        if not self.flags.skip_compact:
            self.maybe_compact()

    def ingest_columns(self, ints: dict | None = None,
                       strs: dict | None = None,
                       sets: dict | None = None,
                       valid: dict | None = None) -> int:
        """Bulk columnar ingest: write blocks directly, bypassing the WAL
        — the reference's ChunkAndSave direct-block path for large
        buffered batches (table.go ChunkAndSave, table_io.go:376).

        ints: {col: int array-like [N]}; strs: {col: list[str] [N]};
        sets: {col: list[list[str]] [N]}; valid: optional {col: bool[N]}
        presence masks (default: all rows populated).  All columns must
        share the same N.  Returns blocks written.
        """
        ints, strs, sets = ints or {}, strs or {}, sets or {}
        valid = valid or {}
        lens = ([len(v) for v in ints.values()]
                + [len(v) for v in strs.values()]
                + [len(v) for v in sets.values()])
        if not lens:
            return 0
        n = lens[0]
        if any(x != n for x in lens):
            raise ValueError("ingest_columns: column lengths differ")

        os.makedirs(self.dir, exist_ok=True)
        # Bulk ingest writes blocks and extends the global string dicts,
        # so it is a digester: take the digest lock (single-writer
        # invariant, dicts.py) and reload dicts from disk under it so we
        # extend the latest published snapshot.
        lock = DigestLock(self.dir)
        if not lock.grab():
            raise IOError(f"could not grab digest lock for {self.name}")
        try:
            self.dicts.reload()
            skip_outliers = self.flags.skip_outliers

            def mask(name) -> np.ndarray:
                m = valid.get(name)
                return (np.asarray(m, dtype=bool) if m is not None
                        else np.ones(n, dtype=bool))

            # convert arrays and assign dict ids OUTSIDE the info lock
            # (dict appends are covered by the digest lock)
            cand_ints = {}
            for name, vals in ints.items():
                cand_ints[name] = (np.asarray(vals, dtype=np.int64),
                                   mask(name))
            cand_strs = {}
            for name, vals in strs.items():
                m = mask(name)
                arr = np.asarray(vals, dtype=object)
                uniq, inverse = np.unique(arr.astype(str),
                                          return_inverse=True)
                gd = self.dicts.get(name)
                remap = np.fromiter((gd.get_or_add(s) for s in uniq.tolist()),
                                    dtype=np.int32, count=len(uniq))
                counts = np.bincount(inverse[m], minlength=len(uniq))
                ids = np.where(m, remap[inverse], 0).astype(np.int32)
                cand_strs[name] = (ids, m, uniq.tolist(), counts)
            cand_sets = {}
            for name, lists in sets.items():
                gd = self.dicts.get(name)
                offsets = np.zeros(n + 1, dtype=np.int64)
                np.cumsum([len(x) for x in lists], out=offsets[1:])
                flat = np.fromiter((gd.get_or_add(s) for lst in lists
                                    for s in lst),
                                   dtype=np.int32, count=int(offsets[-1]))
                cand_sets[name] = (offsets.astype(np.int32), flat)

            # one locked read-modify-write claims key ids/types and folds
            # the stats into the freshest on-disk schema
            accepted: set[str] = set()

            def claim(schema):
                from .schema import IntInfo, StrInfo
                accepted.clear()
                for name, (v, m) in cand_ints.items():
                    kid = schema.get_key_id(name)
                    if not schema.set_key_type(kid, constants.INT_VAL):
                        continue
                    schema.int_info.setdefault(kid, IntInfo()).update_many(
                        v[m], skip_outliers)
                    accepted.add(name)
                for name, (ids, m, uniq, counts) in cand_strs.items():
                    kid = schema.get_key_id(name)
                    if not schema.set_key_type(kid, constants.STR_VAL):
                        continue
                    schema.str_info.setdefault(kid, StrInfo()).update_many(
                        uniq, counts)
                    accepted.add(name)
                for name in cand_sets:
                    kid = schema.get_key_id(name)
                    if schema.set_key_type(kid, constants.SET_VAL):
                        accepted.add(name)

            self.update_info(claim)

            cols: dict[str, blocks.ColumnData] = {}
            for name, (v, m) in cand_ints.items():
                if name in accepted:
                    cols[name] = blocks.IntColumnData(v, m)
            for name, (ids, m, _, _) in cand_strs.items():
                if name in accepted:
                    cols[name] = blocks.StrColumnData(ids, m, [])
            for name, (offsets, flat) in cand_sets.items():
                if name in accepted:
                    cols[name] = blocks.SetColumnData(offsets, flat, [])

            from .digest import save_column_batch
            return save_column_batch(self, cols, n)
        finally:
            lock.release()

    def should_compact(self) -> bool:
        count, size = rowstore.log_stats(self.dir)
        return (count > constants.FILE_DIGEST_THRESHOLD
                or size > constants.SIZE_DIGEST_THRESHOLD)

    def maybe_compact(self) -> None:
        if self.should_compact():
            from .digest import digest_records
            debug("auto-compacting row store for", self.name)
            digest_records(self)

    # ------------------------------------------------------------------
    # info reporting (printer.go:583-598)
    # ------------------------------------------------------------------
    def table_info(self) -> dict:
        count = 0
        size = 0
        for info in self.block_infos().values():
            count += info.num_records
            size += info.size
        return {
            "count": count,
            "storageSize": size,
            "avgObjSize": (size / count) if count else 0.0,
            "columns": {
                "strs": self.schema.cols_of_type(constants.STR_VAL),
                "ints": self.schema.cols_of_type(constants.INT_VAL),
                "sets": self.schema.cols_of_type(constants.SET_VAL),
            },
        }


def list_tables(flags: Flags) -> list[str]:
    if not os.path.isdir(flags.dir):
        return []
    return sorted(e for e in os.listdir(flags.dir)
                  if os.path.isdir(os.path.join(flags.dir, e)))
