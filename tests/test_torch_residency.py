"""Device residency cache of the port: LRU eviction under an overflow
working set (mirrors tests/test_residency.py).

A table whose decoded columns exceed the residency budget must keep
answering queries exactly, evicting LRU entries instead of failing, and
the cache must never exceed its budget.  Runs on the CPU device, where
the cache holds CPU tensors; answers are checked against the JAX
reference on the same table."""

import numpy as np
import torch

import sybil_tpu_torch.digest as dg
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.query.spec import AggDef as RefAgg
from sybil_tpu.query.spec import QueryParams as RefParams
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.ops import residency
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.spec import AggDef, QueryParams
from sybil_tpu_torch.table import Table


def _build(tmp_path, n=4096):
    old = dg.CHUNK_SIZE
    dg.CHUNK_SIZE = 256
    try:
        flags = Flags(dir=str(tmp_path / "db"), table="ov",
                      skip_compact=True, device="cpu")
        t = Table("ov", flags)
        rng = np.random.default_rng(5)
        t.ingest_columns(ints={"v": rng.integers(0, 100, n)},
                         strs={"g": [f"k{i % 7}" for i in range(n)]})
    finally:
        dg.CHUNK_SIZE = old
    return t, flags


def _snap(qr):
    return {k: (r.count, r.samples, round(r.hists["v"].mean(), 9))
            for k, r in qr.results.items()}


def test_residency_overflow_evicts_and_stays_exact(tmp_path):
    t, flags = _build(tmp_path)
    params = QueryParams(groups=("g",), aggs=(AggDef("v", "avg"),))

    cache = residency.CACHE
    old_max = cache.max_bytes
    cache.clear()
    try:
        # budget far below the table's decoded working set (each batch
        # column decodes to [B, C] int64 + validity)
        cache.max_bytes = 64 << 10
        base = run_query(t, params, flags)
        assert cache.bytes <= cache.max_bytes, "budget exceeded"
        m0 = cache.misses

        again = run_query(t, params, flags)
        # overflow working set: later batches evicted earlier ones, so
        # the second scan cannot be all-hit — it decodes evictees again
        assert cache.misses > m0, "expected re-decodes after eviction"
        assert cache.bytes <= cache.max_bytes
        assert _snap(again) == _snap(base)
        assert base.matched_count == 4096

        ref = ref_run_query(
            RefTable("ov", RefFlags(dir=flags.dir, table="ov")),
            RefParams(groups=("g",), aggs=(RefAgg("v", "avg"),)),
            RefFlags(dir=flags.dir, table="ov"))
        assert _snap(base) == _snap(ref)

        # sanity: with a real budget the same table becomes resident
        cache.clear()
        cache.max_bytes = 1 << 30
        run_query(t, params, flags)
        h0, m1 = cache.hits, cache.misses
        run_query(t, params, flags)
        assert cache.hits > h0, "expected residency hits under budget"
        assert cache.misses == m1, "a warm query decoded again"
    finally:
        cache.max_bytes = old_max
        cache.clear()


def test_put_sizes_entries_by_tensor_bytes():
    cache = residency.DeviceColumnCache(max_bytes=10_000)
    v = torch.zeros((2, 256), dtype=torch.int64)      # 4096 B
    m = torch.zeros((2, 256), dtype=torch.bool)       # 512 B
    cache.put("a", (v, m, (256, 256)))
    assert cache.bytes == 4608
    cache.put("b", (v.clone(), m.clone(), (256, 256)))
    assert cache.bytes == 9216 and cache.get("a") is not None
    cache.put("c", (v.clone(), m.clone(), (256, 256)))   # evicts LRU "b"
    assert cache.bytes == 9216
    assert cache.get("b") is None and cache.get("c") is not None
    cache.put("c", (m,))                                  # replace in place
    assert cache.bytes == 4608 + 512


def test_device_const_is_content_keyed():
    a = residency.device_const(np.arange(4, dtype=np.int32), "cpu")
    b = residency.device_const(np.arange(4, dtype=np.int32), "cpu")
    c = residency.device_const(np.arange(5, dtype=np.int32), "cpu")
    assert a is b and c is not a
    assert a.dtype == torch.int32 and a.tolist() == [0, 1, 2, 3]


def test_block_col_key_tracks_mtime(tmp_path):
    p = tmp_path / "int_v.sy"
    p.write_bytes(b"x")
    k1 = residency.block_col_key(str(tmp_path), "int_v.sy", "v", 1024)
    assert k1[:3] == (str(tmp_path), "v", 1024) and k1[3] > 0
    missing = residency.block_col_key(str(tmp_path), "int_w.sy", "w", 1024)
    assert missing[3] == -1
