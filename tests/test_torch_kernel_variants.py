"""kernel_variants.py's variants against the committed sources: each text
replacement must find its text in the source it patches, and each module
constant it sets must be one that ops/scan.py has, so that every variant
still builds the design it names (the variants themselves only run on
the card)."""

import os

import pytest

from sybil_tpu_torch import kernel_variants
from sybil_tpu_torch.ops import scan


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_variant_patches_the_committed_source(name):
    src, reps, consts = kernel_variants.VARIANTS[name]
    with open(os.path.join(kernel_variants.CSRC, src + ".cu")) as f:
        text = f.read()
    for old, new in reps:
        assert old in text, f"{name}: {old!r} is not in {src}.cu"
        assert new != old
    for const in consts:
        assert hasattr(scan, const), f"{name}: scan has no {const}"
