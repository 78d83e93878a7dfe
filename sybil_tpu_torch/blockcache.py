"""Batched block-info cache.

The reference stores `SavedBlockCache` files of 64 block infos each
under `db/T/cache/` so table scans skip opening every block's info.db
(src/lib/table_io.go:242-368, BLOCKS_PER_CACHE_FILE table_io.go:24).
Same idea here: `cache/blocks_*.json.gz` maps block name -> info JSON.
Only FULL (immutable, CHUNK_SIZE-record) blocks are cached — partial
blocks get rewritten by digest top-up, so they are always re-read.
Writers hold the cache lock; corrupt cache files are deleted (the
CacheLock recovery strategy nukes the whole dir)."""

from __future__ import annotations

import gzip
import json
import os
import shutil
import uuid

from . import constants
from .blocks import BlockInfo
from .debug import debug
from .locks import CacheLock

BLOCKS_PER_CACHE_FILE = 64  # table_io.go:24


def _cache_dir(table_dir: str) -> str:
    return os.path.join(table_dir, constants.CACHE_DIR)


def _cache_files(table_dir: str) -> list[str]:
    d = _cache_dir(table_dir)
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, f) for f in os.listdir(d)
            if f.startswith("blocks_") and f.endswith(".json.gz")]


# in-process memo keyed by the cache files' identity: repeated queries in
# a resident process skip re-parsing ~2 MB of gz JSON per query; any
# appended/removed cache file changes the fingerprint and invalidates
_MEMO: dict[str, tuple[tuple, dict]] = {}


def _fingerprint(paths: list[str]) -> tuple:
    out = []
    for p in sorted(paths):
        try:
            st = os.stat(p)
            out.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            out.append((p, -1, -1))
    return tuple(out)


def load(table_dir: str) -> dict[str, BlockInfo]:
    """All cached block infos, keyed by block name."""
    paths = _cache_files(table_dir)
    fp = _fingerprint(paths)
    memo = _MEMO.get(table_dir)
    if memo is not None and memo[0] == fp:
        return memo[1]
    out: dict[str, BlockInfo] = {}
    for path in paths:
        try:
            with gzip.open(path, "rt") as f:
                batch = json.load(f)
            for name, d in batch.items():
                out[name] = BlockInfo.from_json(d)
        except (OSError, ValueError, KeyError):
            debug("deleting corrupt block cache file", path)
            try:
                os.unlink(path)
            except OSError:
                pass
    _MEMO[table_dir] = (fp, out)
    return out


def append(table_dir: str, infos: dict[str, BlockInfo]) -> None:
    """Write newly-seen block infos as fresh cache files (64 per file)."""
    if not infos:
        return
    lock = CacheLock(table_dir)
    if not lock.grab():
        return  # cache is best-effort; skip on contention
    try:
        os.makedirs(_cache_dir(table_dir), exist_ok=True)
        items = list(infos.items())
        for i in range(0, len(items), BLOCKS_PER_CACHE_FILE):
            batch = {name: info.to_json()
                     for name, info in items[i: i + BLOCKS_PER_CACHE_FILE]}
            path = os.path.join(_cache_dir(table_dir),
                                f"blocks_{uuid.uuid4().hex[:12]}.json.gz")
            tmp = path + ".tmp"
            with gzip.open(tmp, "wt") as f:
                json.dump(batch, f)
            os.rename(tmp, path)
        debug("cached", len(items), "block infos for", table_dir)
    finally:
        lock.release()


def clear(table_dir: str) -> None:
    """Drop the cache (after index/rebuild rewrite block stats)."""
    lock = CacheLock(table_dir)
    if not lock.grab():
        return
    try:
        for path in _cache_files(table_dir):
            try:
                os.unlink(path)
            except OSError:
                pass
    finally:
        lock.release()
