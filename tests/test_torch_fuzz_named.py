"""The sweep's named shapes on the CPU (chip_smoke.FUZZ_NAMED, the
sharded two in tests/test_torch_fuzz_mesh.py): one shape for each
strategy and form that a seed might miss, as the card's fuzz_phase runs
them, on tests/test_torch_fuzz.py's table, each through the reference's
run_query, the port's on the CPU and the port's oracle, under that
file's tolerance.  On the CPU the kernels' forms are their plain
versions; the strategy each shape takes (dense, windowed, sorted with
int64 keys, the t-digest pairs, enumerated, the sorted device prune, the
device HLL, the distinct pairs, set filters, the query cache written
and hit) is the bind's, as on the card, and each shape must take the
form FUZZ_NAMED names for it."""

import pytest

import chip_smoke as cs
from test_torch_fuzz import cache_chunk, run_shape, table  # noqa: F401

NAMED = [label for label, shape, _, _ in cs.fuzz_named(0)
         if not shape.get("data_shards")]


@pytest.mark.parametrize("label", NAMED)
def test_named_shape_matches_reference_and_oracle(table, label):
    d, nblocks = table
    shape, want = {n: (s, f) for n, s, f, _ in cs.fuzz_named(nblocks)}[label]
    form = run_shape(d, nblocks, label, shape)
    assert form.startswith(want), f"{label}: takes {form!r}, not {want!r}"
