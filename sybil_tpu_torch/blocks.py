"""Columnar block store.

Logical model follows the reference (immutable 64Ki-record blocks, one file
per column, per-block stats, atomic `.partial` -> live publish with a
validation re-read — src/lib/column_store_io.go:364-491) but the physical
format is flat binary containers (codec.py) designed for device decode:

- int column, "value" encoding: dense delta-encoded int64 values (missing
  slots carry a 0 delta so a single prefix-sum reconstructs the lane) plus
  a validity bitset.  Delta decode is a cumsum — ideal for TPU.
- int/str column, "bucket" encoding (<= CARDINALITY_THRESHOLD distinct):
  sorted unique values, CSR offsets, and posting record-ids delta-encoded
  *across* segment boundaries so one global cumsum yields absolute ids;
  the dense lane is then two scatters.  (Reference: value->posting-list
  bins + per-segment delta encode, column_store_io.go:21-61.)
- str columns store global dictionary ids (table-wide), unlike the
  reference's block-local ids; the block also carries its local dict so a
  lost global dict can be rebuilt (`rebuild`).  Global ids make group keys
  comparable across blocks without a remap gather in the scan kernel.
- set column: CSR offsets + global-id values.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field

import numpy as np

from . import codec
from .constants import (BLOCK_VERSION, CARDINALITY_THRESHOLD, INT_VAL,
                        SET_VAL, STR_VAL)
from .debug import debug, warn
from .schema import IntInfo, Schema, StrInfo


# ---------------------------------------------------------------------------
# in-memory columnar batch
# ---------------------------------------------------------------------------

@dataclass
class IntColumnData:
    values: np.ndarray          # int64[N]
    valid: np.ndarray           # bool[N]
    typ: int = INT_VAL


@dataclass
class StrColumnData:
    ids: np.ndarray             # int32[N] global dict ids
    valid: np.ndarray           # bool[N]
    local_dict: list[str] = field(default_factory=list)
    typ: int = STR_VAL


@dataclass
class SetColumnData:
    offsets: np.ndarray         # int32[N+1]
    values: np.ndarray          # int32[nnz] global dict ids
    local_dict: list[str] = field(default_factory=list)
    typ: int = SET_VAL

    @property
    def valid(self) -> np.ndarray:
        return np.diff(self.offsets) > 0


ColumnData = IntColumnData | StrColumnData | SetColumnData


def pack_bits(valid: np.ndarray) -> np.ndarray:
    return np.packbits(valid.astype(np.uint8), bitorder="little")


def unpack_bits(bits: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(bits, count=n, bitorder="little").astype(bool)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _narrow(arr: np.ndarray) -> np.ndarray:
    """Downcast to the narrowest signed int dtype that holds the range —
    decode is a widening cumsum either way, and narrow deltas cut the
    host->HBM transfer (the device-decode path uploads them raw)."""
    if not len(arr):
        return arr.astype(np.int8)
    lo, hi = int(arr.min()), int(arr.max())
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return arr.astype(dt)
    return arr


def _delta_encode_dense(values: np.ndarray, valid: np.ndarray):
    """Delta-encode a dense lane; missing slots get delta 0 so the decoder's
    cumsum carries the previous value through them (masked out by validity).
    Returns (deltas, base): deltas[0] is relative to `base` (stored in the
    column meta) so a huge absolute first value (e.g. a unix timestamp)
    doesn't force the whole delta array to int64."""
    filled = values.copy()
    if not valid.all():
        # forward-fill missing slots so deltas through them are 0
        idx = np.where(valid, np.arange(len(values)), -1)
        np.maximum.accumulate(idx, out=idx)
        filled = np.where(idx >= 0, values[np.clip(idx, 0, None)], 0)
    deltas = np.empty_like(filled)
    base = int(filled[0])
    deltas[0] = 0
    np.subtract(filled[1:], filled[:-1], out=deltas[1:])
    return _narrow(deltas), base


def _bucket_encode(values: np.ndarray, valid: np.ndarray):
    """-> (uniq values, CSR offsets, WITHIN-segment delta-encoded record
    ids, per-segment first-row bases int32[card]).

    Ids ascend within each value's posting segment (stable argsort), so
    within-segment deltas are small positive gaps that narrow to int8 for
    typical data.  v1 delta-encoded ACROSS segments, where one backwards
    segment-boundary jump (down to -CHUNK_SIZE) forced the whole array to
    int32 — 4x the bytes on disk AND on the warm-up host->HBM upload.
    Decoders reconstruct with one cumsum + a per-segment base gather."""
    rows = np.nonzero(valid)[0].astype(np.int64)
    present = values[rows]
    order = np.argsort(present, kind="stable")
    sorted_vals = present[order]
    sorted_rows = rows[order]
    uniq, starts = np.unique(sorted_vals, return_index=True)
    offsets = np.empty(len(uniq) + 1, dtype=np.int32)
    offsets[:-1] = starts
    offsets[-1] = len(sorted_rows)
    deltas = np.empty(len(sorted_rows), dtype=np.int64)
    if len(sorted_rows):
        deltas[1:] = sorted_rows[1:] - sorted_rows[:-1]
        deltas[starts] = 0
    seg_bases = sorted_rows[starts].astype(np.int32) if len(uniq) \
        else np.zeros(0, dtype=np.int32)
    # within-segment gaps are >= 0 and < CHUNK_SIZE: unsigned dtypes
    # reach twice as far, so a rare value's large gap costs uint16, not
    # int32 for the whole array
    hi = int(deltas.max()) if len(deltas) else 0
    if hi < 256:
        deltas = deltas.astype(np.uint8)
    elif hi < 65536:
        deltas = deltas.astype(np.uint16)
    else:
        deltas = deltas.astype(np.int32)
    return uniq, offsets, deltas, seg_bases


def encode_int_column(col: IntColumnData) -> tuple[dict, dict]:
    n = len(col.values)
    present = col.values[col.valid]
    card = len(np.unique(present)) if len(present) else 0
    if card and card <= CARDINALITY_THRESHOLD:
        uniq, offsets, deltas, seg_bases = _bucket_encode(col.values,
                                                          col.valid)
        meta = {"type": "int", "encoding": "bucket", "num_records": n,
                "cardinality": int(card), "version": BLOCK_VERSION}
        return meta, {"uniq": uniq.astype(np.int64), "offsets": offsets,
                      "id_deltas": deltas, "seg_bases": seg_bases}
    deltas, base = _delta_encode_dense(col.values, col.valid)
    meta = {"type": "int", "encoding": "value", "num_records": n,
            "cardinality": int(card), "base": base,
            "version": BLOCK_VERSION}
    return meta, {"deltas": deltas,
                  "valid_bits": pack_bits(col.valid)}


def _dict_sections(local_dict: list[str]):
    encoded = [s.encode("utf-8") for s in local_dict]
    blob = b"".join(encoded)
    offsets = np.zeros(len(local_dict) + 1, dtype=np.uint32)
    if encoded:
        offsets[1:] = np.cumsum([len(e) for e in encoded], dtype=np.uint32)
    return {"dict_blob": np.frombuffer(blob, dtype=np.uint8).copy(),
            "dict_offsets": offsets}


def dict_from_sections(container: codec.Container) -> list[str]:
    blob = container.read("dict_blob").tobytes()
    offsets = container.read("dict_offsets")
    return [blob[offsets[i]: offsets[i + 1]].decode("utf-8")
            for i in range(len(offsets) - 1)]


def encode_str_column(col: StrColumnData) -> tuple[dict, dict]:
    n = len(col.ids)
    card = len(col.local_dict)
    sections = _dict_sections(col.local_dict)
    if card and card <= CARDINALITY_THRESHOLD:
        uniq, offsets, deltas, seg_bases = _bucket_encode(
            col.ids.astype(np.int64), col.valid)
        meta = {"type": "str", "encoding": "bucket", "num_records": n,
                "cardinality": int(card), "version": BLOCK_VERSION}
        sections.update({"uniq": uniq.astype(np.int32), "offsets": offsets,
                         "id_deltas": deltas, "seg_bases": seg_bases})
    else:
        meta = {"type": "str", "encoding": "value", "num_records": n,
                "cardinality": int(card), "version": BLOCK_VERSION}
        sections.update({"ids": col.ids.astype(np.int32),
                         "valid_bits": pack_bits(col.valid)})
    return meta, sections


def encode_set_column(col: SetColumnData) -> tuple[dict, dict]:
    n = len(col.offsets) - 1
    meta = {"type": "set", "encoding": "csr", "num_records": n,
            "cardinality": len(col.local_dict), "version": BLOCK_VERSION}
    sections = _dict_sections(col.local_dict)
    sections.update({"offsets": col.offsets.astype(np.int32),
                     "values": col.values.astype(np.int32)})
    return meta, sections


# ---------------------------------------------------------------------------
# host decoders (oracle/samples path; the scan path decodes on device)
# ---------------------------------------------------------------------------

def decode_int_container(c: codec.Container) -> IntColumnData:
    n = c.meta["num_records"]
    if c.meta["encoding"] == "value":
        values = np.cumsum(c.read("deltas"), dtype=np.int64)
        values += c.meta.get("base", 0)
        valid = unpack_bits(c.read("valid_bits"), n)
        return IntColumnData(values, valid)
    uniq = c.read("uniq").astype(np.int64)
    offsets = c.read("offsets")
    ids, val_idx = _bucket_ids(c, offsets)
    values = np.zeros(n, dtype=np.int64)
    valid = np.zeros(n, dtype=bool)
    values[ids] = uniq[val_idx]
    valid[ids] = True
    return IntColumnData(values, valid)


def _bucket_ids(c: codec.Container, offsets: np.ndarray):
    """Posting record-ids + value index per posting, for both bucket
    layouts: v2 within-segment deltas + seg_bases, v1 cross-segment
    deltas + id_base meta."""
    cum = np.cumsum(c.read("id_deltas"), dtype=np.int64)
    val_idx = np.searchsorted(offsets[1:], np.arange(len(cum)),
                              side="right")
    if "seg_bases" in c:
        seg_bases = c.read("seg_bases").astype(np.int64)
        starts = offsets[:-1].astype(np.int64)
        ids = seg_bases[val_idx] + (cum - cum[starts[val_idx]])
    else:
        ids = cum + c.meta.get("id_base", 0)
    return ids, val_idx


def decode_str_container(c: codec.Container) -> StrColumnData:
    n = c.meta["num_records"]
    local_dict = dict_from_sections(c) if "dict_offsets" in c else []
    if c.meta["encoding"] == "value":
        ids = c.read("ids").astype(np.int32)
        valid = unpack_bits(c.read("valid_bits"), n)
        return StrColumnData(ids, valid, local_dict)
    uniq = c.read("uniq").astype(np.int64)
    offsets = c.read("offsets")
    rid, val_idx = _bucket_ids(c, offsets)
    ids = np.zeros(n, dtype=np.int32)
    valid = np.zeros(n, dtype=bool)
    ids[rid] = uniq[val_idx].astype(np.int32)
    valid[rid] = True
    return StrColumnData(ids, valid, local_dict)


def decode_set_container(c: codec.Container) -> SetColumnData:
    local_dict = dict_from_sections(c) if "dict_offsets" in c else []
    return SetColumnData(c.read("offsets").astype(np.int32),
                         c.read("values").astype(np.int32), local_dict)


# ---------------------------------------------------------------------------
# block IO
# ---------------------------------------------------------------------------

def column_file(typ: int, name: str) -> str:
    prefix = {INT_VAL: "int", STR_VAL: "str", SET_VAL: "set"}[typ]
    # same naming scheme as the reference's int_COL.db / str_COL.db / set_COL.db
    # (column_store_io.go:117,280,194) with the container extension
    return f"{prefix}_{name}.sy"


@dataclass
class BlockInfo:
    num_records: int
    int_info: dict[int, IntInfo]
    str_info: dict[int, StrInfo]
    size: int = 0
    # EXACT per-column [min, max] over present values — unlike IntInfo,
    # whose min/max replicate the reference's outlier-resistant update
    # (table_column_info.go:75-131) and may UNDERSTATE the range.  The
    # engine uses these to bound aggregation-lane magnitudes statically
    # (ops/scan.py limb compression); absent for blocks written before
    # the field existed, which simply disables the optimization.
    int_exact: dict[int, tuple[int, int]] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.int_exact is None:
            self.int_exact = {}

    def to_json(self):
        return {"num_records": self.num_records,
                "int_info": {str(k): v.to_json() for k, v in self.int_info.items()},
                "str_info": {str(k): v.to_json() for k, v in self.str_info.items()},
                "int_exact": {str(k): [int(lo), int(hi)]
                              for k, (lo, hi) in self.int_exact.items()},
                "size": self.size, "version": BLOCK_VERSION}

    @classmethod
    def from_json(cls, d):
        return cls(d["num_records"],
                   {int(k): IntInfo.from_json(v) for k, v in d.get("int_info", {}).items()},
                   {int(k): StrInfo.from_json(v) for k, v in d.get("str_info", {}).items()},
                   d.get("size", 0),
                   {int(k): (int(v[0]), int(v[1]))
                    for k, v in d.get("int_exact", {}).items()})


def compute_block_info(cols: dict[str, ColumnData], schema: Schema,
                       skip_outliers: bool = True) -> BlockInfo:
    n = 0
    int_info: dict[int, IntInfo] = {}
    str_info: dict[int, StrInfo] = {}
    int_exact: dict[int, tuple[int, int]] = {}
    for name, col in cols.items():
        kid = schema.get_key_id(name)
        if isinstance(col, IntColumnData):
            n = max(n, len(col.values))
            info = IntInfo()
            present = col.values[col.valid]
            info.update_many(present, skip_outliers)
            int_info[kid] = info
            if len(present):
                int_exact[kid] = (int(present.min()), int(present.max()))
        elif isinstance(col, StrColumnData):
            n = max(n, len(col.ids))
            si = StrInfo()
            present = col.ids[col.valid]
            if len(present):
                uniq, counts = np.unique(present, return_counts=True)
                # record top strings by global id (display resolved later)
                si.update_many([str(u) for u in uniq], counts)
            str_info[kid] = si
        else:
            n = max(n, len(col.offsets) - 1)
    return BlockInfo(n, int_info, str_info, int_exact=int_exact)


def save_block(table_dir: str, block_name: str, cols: dict[str, ColumnData],
               schema: Schema, skip_outliers: bool = True) -> BlockInfo:
    """Write a block to `<block>.partial/`, validate by re-reading, then
    atomically swap live (column_store_io.go:419-491)."""
    block_dir = os.path.join(table_dir, block_name)
    partial = block_dir + ".partial"
    if os.path.exists(partial):
        shutil.rmtree(partial)
    os.makedirs(partial, exist_ok=True)

    info = compute_block_info(cols, schema, skip_outliers)
    size = 0
    for name, col in cols.items():
        if isinstance(col, IntColumnData):
            meta, sections = encode_int_column(col)
        elif isinstance(col, StrColumnData):
            meta, sections = encode_str_column(col)
        else:
            meta, sections = encode_set_column(col)
        meta["name"] = name
        path = os.path.join(partial, column_file(col.typ, name))
        codec.write_container(path, meta, sections)
        size += os.path.getsize(path)
    info.size = size
    codec.write_json_atomic(os.path.join(partial, "info.json"), info.to_json())

    # validation re-read before publish
    check = BlockInfo.from_json(codec.read_json(os.path.join(partial, "info.json")))
    if check.num_records != info.num_records:
        warn("block validation failed for", block_name)
        shutil.rmtree(partial)
        raise IOError(f"block validation failed: {block_name}")

    old = block_dir + ".old"
    if os.path.exists(block_dir):
        os.rename(block_dir, old)
    os.rename(partial, block_dir)
    if os.path.exists(old):
        shutil.rmtree(old)
    debug("saved block", block_name, "records", info.num_records)
    return info


def load_block_info(block_dir: str) -> BlockInfo | None:
    try:
        return BlockInfo.from_json(codec.read_json(os.path.join(block_dir, "info.json")))
    except (FileNotFoundError, ValueError, KeyError):
        return None


def open_column(block_dir: str, typ: int, name: str) -> codec.Container | None:
    path = os.path.join(block_dir, column_file(typ, name))
    try:
        return codec.read_container(path)
    except FileNotFoundError:
        return None


def load_block_columns(block_dir: str, schema: Schema,
                       names: list[str]) -> dict[str, ColumnData]:
    """Host-decoded columns (used by the oracle engine, samples, export)."""
    out: dict[str, ColumnData] = {}
    for name in names:
        typ = schema.col_type(name)
        c = open_column(block_dir, typ, name)
        if c is None:
            continue
        if typ == INT_VAL:
            out[name] = decode_int_container(c)
        elif typ == STR_VAL:
            out[name] = decode_str_container(c)
        elif typ == SET_VAL:
            out[name] = decode_set_container(c)
    return out
