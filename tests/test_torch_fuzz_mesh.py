"""The sweep through the mesh on the CPU: 8 seeded shapes (chip_smoke's
fuzz_shape at tests/test_fuzz_parity.py:127's seed, FUZZ_MESH_SEED) and
FUZZ_NAMED's two sharded shapes (a dense and a sorted scan) at
-data-shards 8, on tests/test_torch_fuzz.py's table.  Each runs sharded
and unsharded through the reference's run_query (8 XLA CPU devices,
tests/conftest.py) and the port's on the CPU (the mesh scan over 8
local shards), and sharded through the port's oracle: the port's
sharded and unsharded answers equal the reference's, exactly (float
means within 1e-12 relative), and its sharded answer equals the
oracle's under tests/test_torch_fuzz.py's rules."""

import random

import pytest

import chip_smoke as cs
from test_torch_fuzz import CHUNK, cache_chunk, run_shape, table  # noqa: F401

N_RANDOM = 8
MESH_D = 8


def shapes(nblocks: int) -> list:
    rng = random.Random(cs.FUZZ_MESH_SEED)
    return [dict(cs.fuzz_shape(rng, nblocks, CHUNK), data_shards=MESH_D)
            for _ in range(N_RANDOM)]


@pytest.mark.parametrize("i", range(N_RANDOM))
def test_sharded_random_shape_matches_reference_and_oracle(table, i):
    d, nblocks = table
    run_shape(d, nblocks, f"sharded random {i}", shapes(nblocks)[i])


NAMED = [label for label, shape, _, _ in cs.fuzz_named(0)
         if shape.get("data_shards")]


@pytest.mark.parametrize("label", NAMED)
def test_sharded_named_shape_matches_reference_and_oracle(table, label):
    d, nblocks = table
    shape, want = {n: (s, f) for n, s, f, _ in cs.fuzz_named(nblocks)}[label]
    form = run_shape(d, nblocks, label, shape)
    assert form.startswith(want), f"{label}: takes {form!r}, not {want!r}"
