"""Ingestion: JSON-lines / CSV -> typed records -> row-store WAL.

Type-inference rules are an exact port of the reference's
ingest_dictionary (src/cmd/cmd_ingest.go:26-91):

- nested dicts are flattened with a `parent_` prefix
- JSON arrays become set columns (strings kept; numbers formatted %.0f)
- floats and bools are truncated/cast to int64
- strings stay strings unless the column is in `-ints` (parse int) or
  `-timestamps` (parse via timestamp-format into unix seconds)
- nulls and unknown types are skipped
- a `-path $.a.b` JSON path can select a sub-record (cmd_ingest.go:145)

Ingest also maintains the table-level schema + online stats exactly the
way the reference's AddIntField/AddStrField/AddSetField do
(src/lib/record.go:103-140): stats update per record in arrival order.
"""

from __future__ import annotations

import csv
import json
import sys
from datetime import datetime, timezone

import numpy as np

from .config import Flags
from .constants import INT_VAL, SET_VAL, STR_VAL
from .debug import debug
from .schema import IntInfo, Schema, StrInfo


def _parse_timestamp(value: str, fmt: str) -> int | None:
    """RFC3339 and strftime-style formats -> local-time unix seconds."""
    try:
        if fmt in ("", "rfc3339", "2006-01-02T15:04:05Z07:00"):
            dt = datetime.fromisoformat(value.replace("Z", "+00:00"))
        else:
            dt = datetime.strptime(value, fmt)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return int(dt.timestamp())
    except ValueError:
        return None


def json_path_query(obj, path: str):
    """Port of json_query (cmd_ingest.go:145-186)."""
    ret = obj
    for key in path.split("."):
        if key == "$" or ret is None:
            continue
        if isinstance(ret, dict):
            ret = ret.get(key)
        elif isinstance(ret, list):
            try:
                ret = ret[int(key)]
            except (ValueError, IndexError):
                debug("non-integer or out-of-range key into array", key)
    if isinstance(ret, list):
        return ret
    if isinstance(ret, dict):
        return [ret]
    return []


def flatten_record(recordmap: dict, prefix: str = "", *,
                   excludes: frozenset = frozenset(),
                   int_casts: frozenset = frozenset(),
                   timestamps: frozenset = frozenset(),
                   timestamp_format: str = "") -> dict:
    """-> {"i": {col: int}, "s": {col: str}, "e": {col: [str]}}"""
    ints: dict[str, int] = {}
    strs: dict[str, str] = {}
    sets: dict[str, list[str]] = {}
    _flatten(recordmap, prefix, ints, strs, sets, excludes, int_casts,
             timestamps, timestamp_format)
    out = {}
    if ints:
        out["i"] = ints
    if strs:
        out["s"] = strs
    if sets:
        out["e"] = sets
    return out


def _flatten(recordmap, prefix, ints, strs, sets, excludes, int_casts,
             timestamps, timestamp_format):
    for k, v in recordmap.items():
        key_name = f"{prefix}{k}"
        if key_name in excludes:
            continue
        if isinstance(v, bool):          # bool before int: bool is int in py
            ints[key_name] = 1 if v else 0
        elif isinstance(v, str):
            if key_name in timestamps:
                ts = _parse_timestamp(v, timestamp_format)
                if ts is not None:
                    ints[key_name] = ts
                continue
            if key_name in int_casts:
                try:
                    ints[key_name] = int(v, 10)
                except ValueError:
                    debug("problem parsing", v, "as int for", key_name)
                continue
            strs[key_name] = v
        elif isinstance(v, int):
            ints[key_name] = v
        elif isinstance(v, float):
            ints[key_name] = int(v)      # truncation toward zero, like Go
        elif isinstance(v, dict):
            _flatten(v, f"{key_name}_", ints, strs, sets, excludes,
                     int_casts, timestamps, timestamp_format)
        elif isinstance(v, list):
            key_strs = []
            for item in v:
                if isinstance(item, bool):
                    continue             # reference handles only str/num
                if isinstance(item, str):
                    key_strs.append(item)
                elif isinstance(item, float):
                    key_strs.append(f"{item:.0f}")
                elif isinstance(item, int):
                    key_strs.append(str(item))
            sets[key_name] = key_strs
        elif v is None:
            pass
        else:
            debug("unknown type for field", key_name, type(v))


def update_schema_stats(schema: Schema, records: list[dict],
                        skip_outliers: bool = True) -> None:
    """Register columns/types and update table-level online stats the way
    AddIntField/AddStrField/AddSetField do at ingest time (record.go:103-140).
    Int stats are order-dependent (outlier-gated Welford), so values are fed
    per column in arrival order."""
    int_batches: dict[str, list[int]] = {}
    str_batches: dict[str, list[str]] = {}
    for rec in records:
        for col, val in rec.get("i", {}).items():
            kid = schema.get_key_id(col)
            schema.set_key_type(kid, INT_VAL)
            int_batches.setdefault(col, []).append(val)
        for col, val in rec.get("s", {}).items():
            kid = schema.get_key_id(col)
            schema.set_key_type(kid, STR_VAL)
            str_batches.setdefault(col, []).append(val)
        for col in rec.get("e", {}):
            kid = schema.get_key_id(col)
            schema.set_key_type(kid, SET_VAL)
    for col, vals in int_batches.items():
        kid = schema.key_table[col]
        info = schema.int_info.setdefault(kid, IntInfo())
        info.update_many(np.asarray(vals, dtype=np.int64), skip_outliers)
    for col, vals in str_batches.items():
        kid = schema.key_table[col]
        si = schema.str_info.setdefault(kid, StrInfo())
        si.update_many(vals)


def parse_json_lines(stream, flags: Flags, *, excludes=frozenset(),
                     int_casts=frozenset(), timestamps=frozenset(),
                     timestamp_format: str = "", json_path: str = "$"):
    """Yield typed records from a JSON-lines stream."""
    for line in stream:
        line = line.strip()
        if not line:
            continue
        try:
            decoded = json.loads(line)
        except json.JSONDecodeError as e:
            debug("json parse error:", e)
            continue
        for obj in json_path_query(decoded, json_path):
            if isinstance(obj, dict):
                yield flatten_record(obj, excludes=excludes,
                                     int_casts=int_casts,
                                     timestamps=timestamps,
                                     timestamp_format=timestamp_format)


def parse_csv(stream, flags: Flags):
    """CSV mode: header row, numeric-looking fields become ints
    (cmd_ingest.go:95-143 parses via float then truncates)."""
    reader = csv.reader(stream)
    try:
        header = next(reader)
    except StopIteration:
        return
    for fields in reader:
        ints: dict[str, int] = {}
        strs: dict[str, str] = {}
        for i, v in enumerate(fields):
            if i >= len(header) or v == "":
                continue
            try:
                ints[header[i]] = int(float(v))
            except ValueError:
                strs[header[i]] = v
        rec = {}
        if ints:
            rec["i"] = ints
        if strs:
            rec["s"] = strs
        yield rec
