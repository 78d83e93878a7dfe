"""Columnar batch algebra for the digest/replay path.

The reference replays WAL logs into row structs and re-pivots them per
block (src/lib/table_ingest.go:125, table_io.go:80-130).  Here batches
stay columnar end-to-end: each WAL log decodes (natively when possible,
sybil_tpu/native) into {name: ColumnData}; batches concatenate, sort by
the time column, top up the last partial block, and slice into
CHUNK_SIZE blocks — all as vectorized numpy array ops, no per-row
Python.
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np

from . import native
from .blocks import (ColumnData, IntColumnData, SetColumnData,
                     StrColumnData)
from .constants import INT_VAL, SET_VAL, STR_VAL

Batch = tuple[dict[str, ColumnData], int]


def _decode_dict(blob: bytes, offsets_raw: bytes) -> list[str]:
    offs = np.frombuffer(offsets_raw, dtype=np.uint32)
    return [blob[offs[i]: offs[i + 1]].decode("utf-8")
            for i in range(len(offs) - 1)]


def parse_log_columnar(path: str, table) -> Batch | None:
    """Decode one WAL log natively into global-id ColumnData.  Returns
    None when the native codec is unavailable or the file falls outside
    the WAL shape (caller falls back to the row decoder).  Columns whose
    type conflicts with the schema are dropped, exactly like the row
    pivot (digest.rows_to_columns)."""
    if not native.available():
        return None
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            data = f.read()
    except (OSError, EOFError, zlib.error):
        # truncated/corrupt .wal.gz raises EOFError/zlib.error from the
        # gzip read itself; fall back so the Python path's corrupt-file
        # skip handles it rather than wedging digestion forever
        return None
    raw = native.parse_wal_bytes(data)
    if raw is None:
        return None
    try:
        return _raw_to_batch(raw, table)
    except UnicodeDecodeError:
        # the native decoder emitted bytes Python can't interpret as
        # UTF-8 (an escape shape it doesn't model) — fall back to the
        # Python row decoder, whose json.loads handles such strings
        return None


def _raw_to_batch(raw: dict, table) -> Batch:
    schema = table.schema
    n = raw["n"]
    cols: dict[str, ColumnData] = {}
    for name, (vals_b, valid_b) in raw["ints"].items():
        if schema.col_type(name) != INT_VAL:
            continue
        cols[name] = IntColumnData(
            np.frombuffer(vals_b, dtype=np.int64).copy(),
            np.frombuffer(valid_b, dtype=np.uint8).astype(bool))
    for name, (ids_b, valid_b, (blob, offs_b)) in raw["strs"].items():
        if schema.col_type(name) != STR_VAL:
            continue
        local = _decode_dict(blob, offs_b)
        gd = table.dicts.get(name)
        remap = np.fromiter((gd.get_or_add(s) for s in local),
                            dtype=np.int32, count=len(local))
        lids = np.frombuffer(ids_b, dtype=np.int32)
        valid = np.frombuffer(valid_b, dtype=np.uint8).astype(bool)
        ids = remap[lids] if len(local) else np.zeros(n, dtype=np.int32)
        cols[name] = StrColumnData(np.where(valid, ids, 0).astype(np.int32),
                                   valid, local)
    for name, (items_b, counts_b, (blob, offs_b)) in raw["sets"].items():
        if schema.col_type(name) != SET_VAL:
            continue
        local = _decode_dict(blob, offs_b)
        gd = table.dicts.get(name)
        remap = np.fromiter((gd.get_or_add(s) for s in local),
                            dtype=np.int32, count=len(local))
        litems = np.frombuffer(items_b, dtype=np.int32)
        counts = np.frombuffer(counts_b, dtype=np.int32)
        offsets = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(counts, out=offsets[1:])
        items = remap[litems] if len(local) else np.zeros(0, dtype=np.int32)
        cols[name] = SetColumnData(offsets, items.astype(np.int32), local)
    return cols, n


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
