"""Table-wide string dictionaries.

The reference keeps *block-local* dictionaries with insertion-order ids
(src/lib/table_column.go:27), which makes group keys from different blocks
incomparable without per-block translation.  Here each string column gets
a table-level append-only dictionary built at digest time; blocks store
global ids directly, so the scan kernel compares/groups ids across blocks
with no remapping, and only the final presentation layer resolves strings.

Persisted as a container (blob + offsets) under `db/T/dicts/<col>.sy`,
published atomically.  Only the digester writes (single writer under the
digest lock), so appends are race-free.
"""

from __future__ import annotations

import os

import numpy as np

from . import codec, constants


class GlobalDict:
    def __init__(self, strings: list[str] | None = None):
        self.strings: list[str] = strings or []
        self.index: dict[str, int] = {s: i for i, s in enumerate(self.strings)}
        self.dirty = False

    def get_or_add(self, s: str) -> int:
        gid = self.index.get(s)
        if gid is None:
            gid = len(self.strings)
            self.strings.append(s)
            self.index[s] = gid
            self.dirty = True
        return gid

    def lookup(self, s: str) -> int:
        """-> global id, or -1 when the string was never ingested."""
        return self.index.get(s, -1)

    def __len__(self):
        return len(self.strings)

    def as_array(self) -> np.ndarray:
        return np.asarray(self.strings, dtype=object)


class DictStore:
    def __init__(self, table_dir: str):
        self.dir = os.path.join(table_dir, constants.DICT_DIR)
        self._dicts: dict[str, GlobalDict] = {}
        self._mtimes: dict[str, int] = {}

    def _path(self, col: str) -> str:
        safe = col.replace("/", "%2F")
        return os.path.join(self.dir, f"{safe}.sy")

    def _mtime(self, col: str) -> int:
        try:
            return os.stat(self._path(col)).st_mtime_ns
        except FileNotFoundError:
            return -1

    def get(self, col: str) -> GlobalDict:
        d = self._dicts.get(col)
        if d is not None and not d.dirty:
            # another process may have extended+republished the dict;
            # the file is replaced by rename so mtime is a safe staleness
            # probe.  Dirty (locally extended, unsaved) dicts are never
            # auto-reloaded — writers must call reload() under the digest
            # lock BEFORE extending (see digest.digest_records).
            if self._mtime(col) != self._mtimes.get(col, -1):
                d = None
        if d is None:
            d = self._load(col)
            self._dicts[col] = d
        return d

    def reload(self) -> None:
        """Drop every cached dict so the next get() re-reads from disk.
        Writers call this immediately after acquiring the digest lock so
        they extend the latest published snapshot, never a stale one."""
        self._dicts.clear()
        self._mtimes.clear()

    def _load(self, col: str) -> GlobalDict:
        self._mtimes[col] = self._mtime(col)
        try:
            c = codec.read_container(self._path(col))
        except FileNotFoundError:
            return GlobalDict()
        blob = c.read("blob").tobytes()
        offsets = c.read("offsets")
        strings = [blob[offsets[i]: offsets[i + 1]].decode("utf-8")
                   for i in range(len(offsets) - 1)]
        return GlobalDict(strings)

    def save(self, col: str | None = None) -> None:
        os.makedirs(self.dir, exist_ok=True)
        cols = [col] if col else [c for c, d in self._dicts.items() if d.dirty]
        for c in cols:
            d = self._dicts[c]
            encoded = [s.encode("utf-8") for s in d.strings]
            offsets = np.zeros(len(encoded) + 1, dtype=np.uint64)
            if encoded:
                offsets[1:] = np.cumsum([len(e) for e in encoded], dtype=np.uint64)
            blob = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
            codec.write_container(self._path(c), {"cardinality": len(encoded)},
                                  {"blob": blob, "offsets": offsets})
            d.dirty = False
            self._mtimes[c] = self._mtime(c)
