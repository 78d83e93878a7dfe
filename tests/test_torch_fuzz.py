"""The random-shape sweep (ROADMAP C3) on the CPU: seeded query shapes
through the reference's run_query, the port's run_query on the CPU (the
kernels' plain versions) and the port's copy of the row-at-a-time oracle
(sybil_tpu_torch/query/oracle.py), one test case a shape.

The table is tests/test_fuzz_parity.py:21-51's: its generator and seed
(random.Random(20260821)), 4,000 records written by the reference's
ingest and digest in steps of 1,500, with three changes:
- uid spans 0..5,999 (the reference's 0..300), so that a group by uid
  passes K2's 200 KB shared table (ops/scan.py SHARED_TABLE_BYTES,
  dense_scan_path) and a rollup by uid passes the dense caps;
- CHUNK_SIZE 128 (the reference's 512), so that the table has more than
  16 blocks and the device prune can act (query/engine.py
  _maybe_device_prune), 16 of them full for the query cache (both
  packages' query/cache.py CHUNK_SIZE set to match);
- `user`, uid as a string, drawn with no draw of its own: a str key of
  6,000 values (str-id blocks, str hashes for count distinct).

The shapes are chip_smoke.py's: here 25 from fuzz_shape
(tests/test_fuzz_parity.py:54-87's generator, extended on distincts,
-loghist and -tdigest, -int-bucket, re and nre, order, limit, prune and
device batch) at seed FUZZ_SHAPE_SEED; FUZZ_NAMED's (a shape for each
strategy and form, as the card's fuzz_phase runs them) are in
tests/test_torch_fuzz_named.py, the sharded ones in
tests/test_torch_fuzz_mesh.py, on this file's table.

Tolerance (chip_smoke.fuzz_diff): the port against the reference
exactly (group keys, counts, samples, matched_count, bucket values,
outliers, percentiles, HLL registers, the `sorted` order), float means
within 1e-12 relative; the port against the oracle by
tests/test_query_engine.py:63-84's rules (stddev within 1e-9, mean within
1e-6 relative, a t-digest's count and sum only) with the HLL registers
exact.  Where a prune can drop groups (more groups than 10 x limit), the
port keeps a subset of the oracle's groups: fuzz_diff's docstring says
what then holds.  A cached shape runs twice (written, then hit), each
answer against the reference's and the oracle's."""

import math
import random
import shutil

import pytest

import chip_smoke as cs
import sybil_tpu.digest as ref_digest
import sybil_tpu.query.cache as ref_cache
import sybil_tpu.query.spec as ref_spec
import sybil_tpu_torch.query.spec as port_spec
from sybil_tpu.config import Flags as RefFlags
from sybil_tpu.digest import digest_records
from sybil_tpu.ingest import flatten_record
from sybil_tpu.query.engine import run_query as ref_run_query
from sybil_tpu.table import Table as RefTable
from sybil_tpu_torch.config import Flags
from sybil_tpu_torch.query import cache as port_cache
from sybil_tpu_torch.query.engine import run_query
from sybil_tpu_torch.query.oracle import run_oracle
from sybil_tpu_torch.table import Table

CHUNK = 128
RECORDS = 4000
NAME = "fz"
N_RANDOM = 25


def fuzz_records():
    """tests/test_fuzz_parity.py:24-45's records, uid 0..5,999 and
    `user` added."""
    rng = random.Random(20260821)
    recs = []
    for _ in range(RECORDS):
        rec = {
            "host": f"h{rng.randint(0, 7)}",
            "status": str(rng.choice([200, 404, 500])),
            "ping": rng.randint(-50, 400),
            "weight": rng.choice([1, 2, 10]),
            "uid": rng.randint(0, cs.FUZZ_UIDS - 1),
            "time": cs.FUZZ_TIME0 + rng.randint(0, cs.FUZZ_TIME_SPAN),
            "tags": [f"t{rng.randint(0, 4)}" for _ in
                     range(rng.randint(0, 3))] or ["none"],
        }
        rec["user"] = f"u{rec['uid']}"
        if rng.random() < 0.08:
            del rec["ping"]
        if rng.random() < 0.05:
            del rec["host"]
        recs.append(flatten_record(rec))
    return recs


def build_table(d: str) -> int:
    """The sweep table under d, written by the reference -> its blocks."""
    old = ref_digest.CHUNK_SIZE
    ref_digest.CHUNK_SIZE = CHUNK
    try:
        t = RefTable(NAME, RefFlags(dir=d, table=NAME, skip_compact=True))
        recs = fuzz_records()
        for s in range(0, len(recs), 1500):
            t.ingest_records(recs[s: s + 1500])
            digest_records(t)
    finally:
        ref_digest.CHUNK_SIZE = old
    return len(t.block_infos())


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("db"))
    nblocks = build_table(d)
    assert nblocks > 16
    return d, nblocks


@pytest.fixture(autouse=True)
def cache_chunk():
    """Both packages' query cache told the table's full-block size."""
    olds = ref_cache.CHUNK_SIZE, port_cache.CHUNK_SIZE
    ref_cache.CHUNK_SIZE = port_cache.CHUNK_SIZE = CHUNK
    yield
    ref_cache.CHUNK_SIZE, port_cache.CHUNK_SIZE = olds


def shapes(nblocks: int) -> list:
    rng = random.Random(cs.FUZZ_SHAPE_SEED)
    return [cs.fuzz_shape(rng, nblocks, CHUNK) for _ in range(N_RANDOM)]


def run_shape(d: str, nblocks: int, label: str, shape: dict) -> None:
    """Run one shape through the three engines and hold the port to the
    reference and to the oracle.  A cached shape runs twice (written,
    then hit); a sharded one (data_shards) also runs unsharded, the
    port's answer held to the reference's in both.  -> the strategy and
    form the port's bind gives the shape (chip_smoke.fuzz_device_prunes)."""
    B = shape["device_batch"]
    D = shape.get("data_shards", 0)
    cached = bool(shape.get("cache"))
    rp = cs.fuzz_params(shape, ref_spec)
    pp = cs.fuzz_params(shape, port_spec)

    def flags(cls, shards, **kw):
        return cls(dir=d, table=NAME, skip_compact=True, device_batch=B,
                   data_shards=shards, cache_queries=cached, **kw)

    pflags = flags(Flags, D, device="cpu")
    oracle = cs.fuzz_snapshot(run_oracle(Table(NAME, pflags), pp, pflags),
                              pp)
    prunes, form = cs.fuzz_device_prunes(Table(NAME, pflags), pflags, pp)
    Bq = min(B, nblocks)
    if D:
        Bq = -(-Bq // D) * D
    prune = cs.fuzz_prune(pp, prunes, math.ceil(nblocks / Bq), cached,
                          len(oracle["results"]))
    runs = [("write", D), ("hit", D)] if cached else [("uncached", D)]
    if D:
        runs.append(("unsharded", 0))
    got, want = [], []
    for run, shards in runs:
        if run != "hit":
            shutil.rmtree(f"{d}/{NAME}/cache", ignore_errors=True)
        rf = flags(RefFlags, shards)
        want.append(cs.fuzz_snapshot(ref_run_query(RefTable(NAME, rf), rp,
                                                   rf), rp))
    for run, shards in runs:
        if run != "hit":
            shutil.rmtree(f"{d}/{NAME}/cache", ignore_errors=True)
        h0 = port_cache.HITS
        pf = flags(Flags, shards, device="cpu")
        got.append(cs.fuzz_snapshot(run_query(Table(NAME, pf), pp, pf), pp))
        assert (port_cache.HITS > h0) == (run == "hit"), run
    where = f"{label} ({form}): {cs.fuzz_label(shape)}"
    for (run, _), g, w in zip(runs, got, want):
        diff = cs.fuzz_diff(g, w, "exact")
        assert diff is None, f"{where}, {run}: port != reference: {diff}"
        diff = cs.fuzz_diff(g, oracle, "oracle", prune,
                            not cs.fuzz_mixed_distinct(shape))
        assert diff is None, f"{where}, {run}: port != oracle: {diff}"
    return form


@pytest.mark.parametrize("i", range(N_RANDOM))
def test_random_shape_matches_reference_and_oracle(table, i):
    d, nblocks = table
    run_shape(d, nblocks, f"random {i}", shapes(nblocks)[i])
