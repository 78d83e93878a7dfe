"""Digestion: row-store WAL -> immutable columnar blocks.

Port of the reference digest pipeline (src/lib/table_ingest.go:287-331,
table_io.go:119-130):

  under the digest lock:
    move ingest/* into a temp stomache dir        (:296-327)
    replay logs into typed rows
    sort rows by the time column                  (table_io.go:121)
    top up the last partial (<64Ki) block         (table_block_io.go:48)
    slice into CHUNK_SIZE blocks, save each via the columnar encoder
    delete consumed logs                          (:259-262)

Differences from the reference: global string dictionaries are extended
here (single writer), so blocks store table-wide ids — see dicts.py.
"""

from __future__ import annotations

import os
import shutil
import uuid

import numpy as np

from . import blocks, constants, rowstore
from .blocks import IntColumnData, SetColumnData, StrColumnData
from .constants import CHUNK_SIZE, INT_VAL, SET_VAL, STR_VAL
from .debug import debug, warn
from .locks import BlockLock, DigestLock
from .table import Table


def rows_to_columns(rows: list[dict], table: Table) -> dict[str, blocks.ColumnData]:
    """Pivot typed rows into columnar arrays with global dict ids."""
    n = len(rows)
    schema = table.schema
    int_cols: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    str_cols: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    set_cols: dict[str, tuple[list, list]] = {}

    for idx, rec in enumerate(rows):
        for col, val in rec.get("i", {}).items():
            if schema.col_type(col) != INT_VAL:
                continue
            arrs = int_cols.get(col)
            if arrs is None:
                arrs = (np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool))
                int_cols[col] = arrs
            arrs[0][idx] = val
            arrs[1][idx] = True
        for col, val in rec.get("s", {}).items():
            if schema.col_type(col) != STR_VAL:
                continue
            arrs = str_cols.get(col)
            if arrs is None:
                arrs = (np.zeros(n, dtype=np.int32), np.zeros(n, dtype=bool))
                str_cols[col] = arrs
            gd = table.dicts.get(col)
            arrs[0][idx] = gd.get_or_add(val)
            arrs[1][idx] = True
        for col, vals in rec.get("e", {}).items():
            if schema.col_type(col) != SET_VAL:
                continue
            lists = set_cols.get(col)
            if lists is None:
                lists = ([[] for _ in range(n)], None)
                set_cols[col] = lists
            gd = table.dicts.get(col)
            lists[0][idx] = [gd.get_or_add(v) for v in vals]

    out: dict[str, blocks.ColumnData] = {}
    for col, (values, valid) in int_cols.items():
        out[col] = IntColumnData(values, valid)
    for col, (ids, valid) in str_cols.items():
        gd = table.dicts.get(col)
        present = np.unique(ids[valid])
        local = [gd.strings[g] for g in present.tolist()]
        out[col] = StrColumnData(ids, valid, local)
    for col, (lists, _) in set_cols.items():
        gd = table.dicts.get(col)
        offsets = np.zeros(n + 1, dtype=np.int32)
        offsets[1:] = np.cumsum([len(x) for x in lists], dtype=np.int64)
        flat = [g for lst in lists for g in lst]
        values = np.asarray(flat, dtype=np.int32)
        present = np.unique(values) if len(values) else np.array([], dtype=np.int32)
        local = [gd.strings[g] for g in present.tolist()]
        out[col] = SetColumnData(offsets, values, local)
    return out


def columns_to_rows(cols: dict[str, blocks.ColumnData], table: Table,
                    n: int) -> list[dict]:
    """Inverse pivot (used to reopen a partial block for topping up)."""
    rows: list[dict] = [{} for _ in range(n)]
    for col, data in cols.items():
        if isinstance(data, IntColumnData):
            for i in np.nonzero(data.valid)[0].tolist():
                rows[i].setdefault("i", {})[col] = int(data.values[i])
        elif isinstance(data, StrColumnData):
            gd = table.dicts.get(col)
            for i in np.nonzero(data.valid)[0].tolist():
                rows[i].setdefault("s", {})[col] = gd.strings[int(data.ids[i])]
        else:
            gd = table.dicts.get(col)
            for i in range(n):
                lo, hi = int(data.offsets[i]), int(data.offsets[i + 1])
                if hi > lo:
                    rows[i].setdefault("e", {})[col] = [
                        gd.strings[int(v)] for v in data.values[lo:hi]]
    return rows


def _time_key(rec: dict, time_col: str) -> int:
    return rec.get("i", {}).get(time_col, 0)


def save_record_list(table: Table, rows: list[dict]) -> int:
    """Sort by time, fill the last partial block, slice into CHUNK_SIZE
    blocks (table_io.go:80-130).  Returns blocks written."""
    if not rows:
        return 0
    rows = sorted(rows, key=lambda r: _time_key(r, table.flags.time_col))

    written = 0
    # --- fill partial block (table_block_io.go:48-108) ---
    partials = [(bdir, info) for bdir, info in table.block_infos().items()
                if info.num_records < CHUNK_SIZE]
    if partials:
        bdir, _ = partials[-1]
        block_name = os.path.basename(bdir)
        lock = BlockLock(table.dir, block_name)
        if lock.grab():
            try:
                # re-read the block info AFTER grabbing the lock: the
                # pre-lock snapshot may be stale if another writer topped
                # up the same block in between
                info = blocks.load_block_info(bdir)
                if info is not None and info.num_records < CHUNK_SIZE:
                    all_cols = _all_column_names(table, bdir)
                    cols = blocks.load_block_columns(bdir, table.schema,
                                                     all_cols)
                    old_rows = columns_to_rows(cols, table, info.num_records)
                    delta = min(CHUNK_SIZE - len(old_rows), len(rows))
                    merged = old_rows + rows[:delta]
                    blocks.save_block(table.dir, block_name,
                                      rows_to_columns(merged, table),
                                      table.schema,
                                      table.flags.skip_outliers)
                    rows = rows[delta:]
                    written += 1
            finally:
                lock.release()

    # --- slice the rest ---
    for start in range(0, len(rows), CHUNK_SIZE):
        chunk = rows[start: start + CHUNK_SIZE]
        name = table.new_block_name()
        lock = BlockLock(table.dir, name)
        if not lock.grab():
            warn("could not lock new block", name)
            continue
        try:
            blocks.save_block(table.dir, name, rows_to_columns(chunk, table),
                              table.schema, table.flags.skip_outliers)
            written += 1
        finally:
            lock.release()

    # dicts extended during replay are published here (under the digest
    # lock); the schema is NOT re-saved — digestion never mutates it, and
    # writing a stale snapshot would clobber concurrent ingesters'
    # schema updates (Table.update_info holds the only write path)
    table.dicts.save()
    return written


def _all_column_names(table: Table, bdir: str) -> list[str]:
    names = []
    for fn in os.listdir(bdir):
        if fn.endswith(".sy") or fn.endswith(".sy.gz"):
            base = fn[:-6] if fn.endswith(".sy.gz") else fn[:-3]
            names.append(base.split("_", 1)[1])
    return names


def replay_logs_columnar(logs: list[str], table: Table):
    """Decode WAL logs into one concatenated columnar batch.  Each log
    goes through the native C++ codec (sybil_tpu/native) when possible,
    falling back per-file to the Python row decoder + pivot; corrupt
    files are skipped (table_ingest.go:125)."""
    from . import columnar
    batches = []
    for log in logs:
        batch = columnar.parse_log_columnar(log, table)
        if batch is None:
            try:
                rows = rowstore.read_log(log)
            except (OSError, EOFError, ValueError) as e:
                warn("skipping corrupt WAL file", log, e)
                continue
            batch = (rows_to_columns(rows, table), len(rows))
        batches.append(batch)
    return columnar.concat_batches(batches)


def save_column_batch(table: Table, cols, n: int) -> int:
    """Columnar save_record_list: sort by time, top up the last partial
    block, slice into CHUNK_SIZE blocks.  Returns blocks written."""
    from . import columnar
    if not n:
        return 0
    cols = columnar.sort_batch_by_time(cols, n, table.flags.time_col)

    written = 0
    consumed = 0
    # --- fill partial block (table_block_io.go:48-108) ---
    partials = [(bdir, info) for bdir, info in table.block_infos().items()
                if info.num_records < CHUNK_SIZE]
    if partials:
        bdir, _ = partials[-1]
        block_name = os.path.basename(bdir)
        lock = BlockLock(table.dir, block_name)
        if lock.grab():
            try:
                # re-read AFTER grabbing the lock (stale pre-lock count
                # would mis-size the concat and corrupt set offsets)
                info = blocks.load_block_info(bdir)
                if info is not None and info.num_records < CHUNK_SIZE:
                    all_cols = _all_column_names(table, bdir)
                    old = blocks.load_block_columns(bdir, table.schema,
                                                    all_cols)
                    delta = min(CHUNK_SIZE - info.num_records, n)
                    merged, m = columnar.concat_batches(
                        [(old, info.num_records),
                         (columnar.slice_batch(cols, 0, delta), delta)])
                    blocks.save_block(table.dir, block_name,
                                      columnar.with_local_dicts(merged, table),
                                      table.schema,
                                      table.flags.skip_outliers)
                    consumed = delta
                    written += 1
            finally:
                lock.release()

    # --- slice the rest ---
    for start in range(consumed, n, CHUNK_SIZE):
        chunk = columnar.slice_batch(cols, start, min(start + CHUNK_SIZE, n))
        name = table.new_block_name()
        lock = BlockLock(table.dir, name)
        if not lock.grab():
            warn("could not lock new block", name)
            continue
        try:
            blocks.save_block(table.dir, name,
                              columnar.with_local_dicts(chunk, table),
                              table.schema, table.flags.skip_outliers)
            written += 1
        finally:
            lock.release()

    # dicts extended during replay are published here (under the digest
    # lock); the schema is NOT re-saved — digestion never mutates it, and
    # writing a stale snapshot would clobber concurrent ingesters'
    # schema updates (Table.update_info holds the only write path)
    table.dicts.save()
    return written


def digest_records(table: Table) -> int:
    """Collate the WAL into columnar blocks; returns records digested."""
    lock = DigestLock(table.dir)
    if not lock.grab():
        warn("could not grab digest lock for", table.name)
        return 0
    try:
        table.load_info()
        # extend the latest published dict snapshot, never a stale cache
        table.dicts.reload()
        logs = rowstore.list_logs(table.dir)
        if not logs:
            return 0
        stomache = os.path.join(table.dir,
                                constants.STOMACHE_DIR + uuid.uuid4().hex[:8])
        os.makedirs(stomache, exist_ok=True)
        moved = []
        for log in logs:
            dest = os.path.join(stomache, os.path.basename(log))
            try:
                os.rename(log, dest)
                moved.append(dest)
            except OSError:
                pass

        cols, n = replay_logs_columnar(moved, table)
        if n:
            save_column_batch(table, cols, n)

        # logs deleted only after blocks validated (table_ingest.go:250-281)
        shutil.rmtree(stomache, ignore_errors=True)
        debug("digested", n, "records into", table.name)
        return n
    finally:
        lock.release()
