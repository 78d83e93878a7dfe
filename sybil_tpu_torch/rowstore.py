"""Row store: the append-only ingestion WAL.

Mirrors the reference row store (src/lib/row_store.go): every ingested
record is durably appended to `db/T/ingest/` *before* ack, via write to
`.ingest.temp/` + atomic rename with retries (row_store.go:244-256).
Digestion later collates logs into columnar blocks and deletes them only
after the blocks validate, so ingestion is crash-safe and idempotent.

Records travel as typed triples {"i": {col: int}, "s": {col: str},
"e": {col: [str, ...]}} — types were already inferred at ingest time —
serialized as gzipped JSON-lines (the reference uses gob of SavedRecord
name-id/value pairs, row_store.go:26).
"""

from __future__ import annotations

import gzip
import json
import os
import time
import uuid

from . import constants
from .debug import debug


def wal_path(table_dir: str) -> str:
    return os.path.join(table_dir, constants.INGEST_DIR)


def append_records_to_log(table_dir: str, records: list[dict],
                          ingest_dir: str = constants.INGEST_DIR) -> str:
    """Write one WAL file containing `records`; returns its final path."""
    temp_dir = os.path.join(table_dir, constants.TEMP_INGEST_DIR)
    final_dir = os.path.join(table_dir, ingest_dir)
    os.makedirs(temp_dir, exist_ok=True)
    os.makedirs(final_dir, exist_ok=True)

    name = f"{int(time.time() * 1000):013d}_{uuid.uuid4().hex[:10]}.wal.gz"
    tmp = os.path.join(temp_dir, name)
    with gzip.open(tmp, "wt") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")))
            f.write("\n")

    final = os.path.join(final_dir, name)
    for attempt in range(3):  # rename retries (row_store.go:244-256)
        try:
            os.rename(tmp, final)
            break
        except OSError:
            if attempt == 2:
                raise
            time.sleep(0.01)
    debug("appended", len(records), "records to", final)
    return final


def read_log(path: str) -> list[dict]:
    records = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def list_logs(table_dir: str, ingest_dir: str = constants.INGEST_DIR) -> list[str]:
    d = os.path.join(table_dir, ingest_dir)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".wal.gz") or f.endswith(".wal"))


def log_stats(table_dir: str) -> tuple[int, int]:
    """(file count, total bytes) of the ingest dir — drives auto-digest
    thresholds (table_ingest.go:77-79)."""
    files = list_logs(table_dir)
    size = sum(os.path.getsize(f) for f in files)
    return len(files), size
