"""Device-resident column cache.

The reference re-reads and re-decodes every block from disk per query
(table_query.go:133); its only reuse is the OS page cache and a per-block
result cache.  Here the decoded working set belongs in device memory:
decoded column lanes are kept per (block, column) batch and pinned until
LRU eviction, so repeated scans touch no host->device transfer and run
no decode kernel at all.

Cache keys include the column file's mtime: blocks are immutable and
republished by rename (column_store_io.go:472-486 equivalent), so an
mtime change invalidates naturally.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

# SYBIL_HBM_BUDGET_BYTES overrides (the MAX_MEM analog,
# table_query.go:15 — tables whose decoded working set exceeds the
# budget degrade to LRU eviction + re-upload, never failure)
MAX_BYTES = int(os.environ.get("SYBIL_HBM_BUDGET_BYTES", 8 << 30))


def _nbytes(obj) -> int:
    """Bytes held by the tensors and arrays inside a cache entry."""
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(x) for x in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(x) for x in obj.values())
    return int(getattr(obj, "nbytes", 0))


class DeviceColumnCache:
    def __init__(self, max_bytes: int = MAX_BYTES):
        self.max_bytes = max_bytes
        self.bytes = 0
        self._lru: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def _evict(self):
        while self.bytes > self.max_bytes and self._lru:
            _, (arrs, nbytes) = self._lru.popitem(last=False)
            self.bytes -= nbytes

    def get(self, key):
        ent = self._lru.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return ent[0]

    def put(self, key, arrays):
        nbytes = _nbytes(arrays)
        if key in self._lru:
            self.bytes -= self._lru[key][1]
        self._lru[key] = (arrays, nbytes)
        self.bytes += nbytes
        self._evict()

    def clear(self):
        self._lru.clear()
        self.bytes = 0


CACHE = DeviceColumnCache()

# Small device-resident constants (per-batch record counts and the
# like): content-keyed, so repeat queries upload nothing at all.
_CONST_MAX_BYTES = 1 << 20
_CONST: "OrderedDict[tuple, object]" = OrderedDict()
_CONST_CAP = 4096


def device_const(arr, device):
    """A device copy of a small host array, cached by content."""
    import torch
    a = np.ascontiguousarray(arr)
    device = torch.device(device)
    if a.nbytes > _CONST_MAX_BYTES:
        return torch.from_numpy(a).to(device)
    key = (str(device), a.dtype.str, a.shape, a.tobytes())
    ent = _CONST.get(key)
    if ent is None:
        ent = torch.from_numpy(a.copy()).to(device)
        _CONST[key] = ent
        if len(_CONST) > _CONST_CAP:
            _CONST.popitem(last=False)
    else:
        _CONST.move_to_end(key)
    return ent


def block_col_key(bdir: str, col_file: str, col: str, C: int) -> tuple:
    path = os.path.join(bdir, col_file)
    try:
        mtime = os.stat(path).st_mtime_ns
    except FileNotFoundError:
        try:
            mtime = os.stat(path + ".gz").st_mtime_ns
        except FileNotFoundError:
            mtime = -1
    return (bdir, col, C, mtime)
