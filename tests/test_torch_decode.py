"""Port decode (sybil_tpu_torch.ops.decode) against the JAX reference.

Containers are encoded by sybil_tpu.blocks, written with sybil_tpu.codec
and read back once; the same Container objects go through the reference's
decode_column_batch and the port's (device="cpu", so K1's plain PyTorch
version).  Every output is an integer or a bool: equality is exact."""

import numpy as np
import pytest
import torch

from sybil_tpu import blocks as ref_blocks
from sybil_tpu import codec as ref_codec
from sybil_tpu.ops.decode import decode_column_batch as ref_decode
from sybil_tpu_torch.ops.decode import decode_bucket2, decode_column_batch


def _container(tmp_path, name, meta, sections):
    path = str(tmp_path / f"{name}.sy")
    ref_codec.write_container(path, meta, sections)
    return ref_codec.read_container(path)


def _int_block(rng, n, card, p_valid, spread=1, lo=0):
    v = (rng.integers(0, card, n).astype(np.int64) * spread) + lo
    m = rng.random(n) < p_valid
    return ref_blocks.encode_int_column(ref_blocks.IntColumnData(v, m))


def _str_block(rng, n, card, p_valid):
    ids = rng.integers(0, card, n).astype(np.int32)
    m = rng.random(n) < p_valid
    return ref_blocks.encode_str_column(
        ref_blocks.StrColumnData(ids, m, [f"s{i}" for i in range(card)]))


def _rare_block(n, every):
    v = np.zeros(n, dtype=np.int64)
    v[::every] = 7
    return ref_blocks.encode_int_column(
        ref_blocks.IntColumnData(v, np.ones(n, bool)))


def _widened(meta_sections):
    meta, s = meta_sections
    s = dict(s)
    s["id_deltas"] = s["id_deltas"].astype(np.int32)
    return meta, s


def _case(name, rng):
    """-> (list of (meta, sections) or None, C, expected delta dtype)."""
    if name == "int-u8":
        return [_int_block(rng, 1024, 5, 0.95), _int_block(rng, 1024, 12,
                                                           1.0)], 1024, "u1"
    if name == "str-u8":
        return [_str_block(rng, 1024, 5, 0.9), _str_block(rng, 1000, 3,
                                                          0.97)], 1024, "u1"
    if name == "int-u16":
        return [_rare_block(4096, 997), _int_block(rng, 4096, 3, 0.9)], \
            4096, "u2"
    if name == "str-u16":
        b = _str_block(rng, 4096, 2, 0.9)
        return [_rare_block(4096, 1500), b], 4096, "u2"
    if name == "int-i32":
        return [_widened(_int_block(rng, 2048, 9, 0.8)),
                _int_block(rng, 2048, 4, 0.9)], 2048, "i4"
    if name == "mixed-widths":
        return [_int_block(rng, 4096, 6, 0.9), _rare_block(4096, 999),
                _widened(_int_block(rng, 4096, 2, 0.5))], 4096, "i4"
    if name == "short-blocks":
        return [_int_block(rng, 1, 1, 1.0), _int_block(rng, 100, 7, 0.9),
                _int_block(rng, 1000, 30, 0.9)], 1024, "u1"
    if name == "missing-blocks":
        return [None, _int_block(rng, 512, 5, 0.9), None,
                _str_block(rng, 300, 11, 0.8), None], 512, "u1"
    if name == "invalid-rows":
        return [_int_block(rng, 2048, 3, 0.01),
                _int_block(rng, 2048, 900, 0.3, spread=-3, lo=-5)], \
            2048, None
    if name == "card-near-cap":
        return [_str_block(rng, 8192, 4999, 0.95),
                _int_block(rng, 8192, 4000, 0.9, lo=1 << 40)], 8192, None
    raise KeyError(name)


CASES = ["int-u8", "str-u8", "int-u16", "str-u16", "int-i32",
         "mixed-widths", "short-blocks", "missing-blocks", "invalid-rows",
         "card-near-cap"]


@pytest.mark.parametrize("name", CASES)
def test_decode_matches_reference(tmp_path, name):
    rng = np.random.default_rng(CASES.index(name))
    encoded, C, dt = _case(name, rng)
    containers = [None if e is None else _container(tmp_path, f"b{i}", *e)
                  for i, e in enumerate(encoded)]
    for c in containers:
        if c is not None:
            assert c.meta["encoding"] == "bucket" and "seg_bases" in c
    if dt is not None:
        wide = np.result_type(*[c.read("id_deltas").dtype
                                for c in containers if c is not None])
        assert wide == np.dtype(dt)
    rv, rm, rn = ref_decode(containers, C)
    pv, pm, pn = decode_column_batch(containers, C, "cpu")
    assert pv.device.type == "cpu" and pv.dtype == torch.int64
    assert pm.dtype == torch.bool
    assert pn == rn
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


def test_decode_value_encoding_not_ported(tmp_path):
    v = np.arange(6000, dtype=np.int64)      # > 5000 distinct: value enc.
    meta, s = ref_blocks.encode_int_column(
        ref_blocks.IntColumnData(v, np.ones(len(v), bool)))
    assert meta["encoding"] == "value"
    c = _container(tmp_path, "v", meta, s)
    with pytest.raises(NotImplementedError, match="B5"):
        decode_column_batch([c], 8192, "cpu")


def test_decode_oversized_block_is_value_error(tmp_path):
    c = _container(tmp_path, "big", *_int_block(
        np.random.default_rng(0), 2048, 3, 1.0))
    with pytest.raises(ValueError):
        decode_column_batch([c], 1024, "cpu")


def test_decode_wrapper_takes_plain_version_on_cpu():
    # a CPU tensor goes to the plain version without touching the build
    d = torch.zeros((1, 128), dtype=torch.uint8)
    v, m = decode_bucket2(d, torch.zeros(1, dtype=torch.int32),
                          torch.full((1, 8), 2**31 - 1, dtype=torch.int32),
                          torch.zeros((1, 8), dtype=torch.int64),
                          torch.zeros((1, 8), dtype=torch.int32),
                          torch.tensor([0, -1], dtype=torch.int32), 128)
    assert v.shape == (2, 128) and not m.any() and not v.any()
