"""Block writing for bulk columnar ingest.

Port of the reference's save path (src/lib/table_io.go:80-130):

    sort rows by the time column                  (table_io.go:121)
    top up the last partial (<64Ki) block         (table_block_io.go:48)
    slice into CHUNK_SIZE blocks, save each via the columnar encoder

Global string dictionaries are extended by the caller (single writer
under the digest lock), so blocks store table-wide ids — see dicts.py.
Replaying the row-store WAL into blocks (digestion proper) is not part
of this package yet.
"""

from __future__ import annotations

import os

from . import blocks
from .constants import CHUNK_SIZE
from .debug import warn
from .locks import BlockLock
from .table import Table


def _all_column_names(table: Table, bdir: str) -> list[str]:
    names = []
    for fn in os.listdir(bdir):
        if fn.endswith(".sy") or fn.endswith(".sy.gz"):
            base = fn[:-6] if fn.endswith(".sy.gz") else fn[:-3]
            names.append(base.split("_", 1)[1])
    return names


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

    # dicts extended during ingest are published here (under the digest
    # lock); the schema is NOT re-saved — writing blocks never mutates
    # it, and writing a stale snapshot would clobber concurrent
    # ingesters' schema updates (Table.update_info holds the only write
    # path)
    table.dicts.save()
    return written
