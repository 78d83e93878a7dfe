"""Columnar batch algebra for the bulk-ingest path.

The reference replays WAL logs into row structs and re-pivots them per
block (src/lib/table_ingest.go:125, table_io.go:80-130).  Here batches
stay columnar end-to-end: {name: ColumnData} batches concatenate, sort by
the time column, top up the last partial block, and slice into
CHUNK_SIZE blocks — all as vectorized numpy array ops, no per-row
Python.  (The native WAL decoder that feeds digestion is not part of
this package yet.)
"""

from __future__ import annotations

import numpy as np

from .blocks import (ColumnData, IntColumnData, SetColumnData,
                     StrColumnData)

Batch = tuple[dict[str, ColumnData], int]


def _empty_like(col: ColumnData, n: int) -> ColumnData:
    if isinstance(col, IntColumnData):
        return IntColumnData(np.zeros(n, np.int64), np.zeros(n, bool))
    if isinstance(col, StrColumnData):
        return StrColumnData(np.zeros(n, np.int32), np.zeros(n, bool), [])
    return SetColumnData(np.zeros(n + 1, np.int32), np.zeros(0, np.int32), [])


def concat_batches(batches: list[Batch]) -> Batch:
    """Concatenate columnar batches; columns missing from a batch pad
    as not-populated rows."""
    batches = [b for b in batches if b[1] > 0]
    if not batches:
        return {}, 0
    if len(batches) == 1:
        return batches[0]
    total = sum(n for _, n in batches)
    names: dict[str, ColumnData] = {}
    for cols, _ in batches:
        for name, col in cols.items():
            names.setdefault(name, col)
    out: dict[str, ColumnData] = {}
    for name, proto in names.items():
        parts = [cols.get(name) or _empty_like(proto, n)
                 for cols, n in batches]
        if isinstance(proto, IntColumnData):
            out[name] = IntColumnData(
                np.concatenate([p.values for p in parts]),
                np.concatenate([p.valid for p in parts]))
        elif isinstance(proto, StrColumnData):
            out[name] = StrColumnData(
                np.concatenate([p.ids for p in parts]),
                np.concatenate([p.valid for p in parts]), [])
        else:
            offsets = np.zeros(total + 1, dtype=np.int64)
            vals = []
            pos, base = 0, 0
            for p, (_, n) in zip(parts, batches):
                offsets[pos + 1: pos + n + 1] = (
                    p.offsets[1:].astype(np.int64) + base)
                base += int(p.offsets[-1])
                pos += n
                vals.append(p.values)
            out[name] = SetColumnData(offsets.astype(np.int32),
                                      np.concatenate(vals), [])
    return out, total


def permute_batch(cols: dict[str, ColumnData], n: int,
                  perm: np.ndarray) -> dict[str, ColumnData]:
    out: dict[str, ColumnData] = {}
    for name, col in cols.items():
        if isinstance(col, IntColumnData):
            out[name] = IntColumnData(col.values[perm], col.valid[perm])
        elif isinstance(col, StrColumnData):
            out[name] = StrColumnData(col.ids[perm], col.valid[perm],
                                      col.local_dict)
        else:
            counts = np.diff(col.offsets)[perm]
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            total = int(offsets[-1])
            starts = col.offsets[:-1][perm].astype(np.int64)
            gather = (np.repeat(starts, counts)
                      + np.arange(total, dtype=np.int64)
                      - np.repeat(offsets[:-1], counts))
            out[name] = SetColumnData(offsets.astype(np.int32),
                                      col.values[gather], col.local_dict)
    return out


def sort_batch_by_time(cols: dict[str, ColumnData], n: int,
                       time_col: str) -> dict[str, ColumnData]:
    """Stable sort by the time column; rows without it sort as 0
    (digest sort semantics, table_io.go:121)."""
    tc = cols.get(time_col)
    if not isinstance(tc, IntColumnData):
        return cols
    key = np.where(tc.valid, tc.values, 0)
    perm = np.argsort(key, kind="stable")
    return permute_batch(cols, n, perm)


def slice_batch(cols: dict[str, ColumnData], lo: int,
                hi: int) -> dict[str, ColumnData]:
    out: dict[str, ColumnData] = {}
    for name, col in cols.items():
        if isinstance(col, IntColumnData):
            out[name] = IntColumnData(col.values[lo:hi], col.valid[lo:hi])
        elif isinstance(col, StrColumnData):
            out[name] = StrColumnData(col.ids[lo:hi], col.valid[lo:hi], [])
        else:
            offs = (col.offsets[lo: hi + 1]
                    - col.offsets[lo]).astype(np.int32)
            vals = col.values[col.offsets[lo]: col.offsets[hi]]
            out[name] = SetColumnData(offs, vals, [])
    return out


def with_local_dicts(cols: dict[str, ColumnData],
                     table) -> dict[str, ColumnData]:
    """Rebuild per-block local dictionaries (the unique present strings)
    from global ids before encoding, as the row pivot does."""
    out: dict[str, ColumnData] = {}
    for name, col in cols.items():
        if isinstance(col, StrColumnData):
            gd = table.dicts.get(name)
            present = np.unique(col.ids[col.valid])
            local = [gd.strings[g] for g in present.tolist()]
            out[name] = StrColumnData(col.ids, col.valid, local)
        elif isinstance(col, SetColumnData):
            gd = table.dicts.get(name)
            present = (np.unique(col.values) if len(col.values)
                       else np.zeros(0, np.int32))
            local = [gd.strings[g] for g in present.tolist()]
            out[name] = SetColumnData(col.offsets, col.values, local)
        else:
            out[name] = col
    return out
