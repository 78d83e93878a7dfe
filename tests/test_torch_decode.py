"""Port decode (sybil_tpu_torch.ops.decode) against the JAX reference.

Containers are encoded by sybil_tpu.blocks, written with sybil_tpu.codec
and read back once; the same Container objects go through the reference's
decode_column_batch and the port's (device="cpu", so K1's plain PyTorch
version).  K6's id mode also runs chip_smoke.py's K6 cases (the card
holds the kernel to its plain version on the same cases).  Every output
is an integer or a bool: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sybil_tpu import blocks as ref_blocks
from sybil_tpu import codec as ref_codec
from sybil_tpu.ops import decode as ref_decode_mod
from sybil_tpu.ops.decode import decode_column_batch as ref_decode
from sybil_tpu_torch.ops import decode as port_decode
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


def _value_block(rng, n, step_lo, step_hi, base, p_valid=1.0):
    """A value-encoded int block: distinct values (a walk whose steps lie
    in [step_lo, step_hi)), so the delta dtype follows the step range."""
    steps = rng.integers(step_lo, step_hi, n).astype(np.int64)
    steps[steps == 0] = 1
    v = base + np.cumsum(steps)
    m = rng.random(n) < p_valid
    meta, s = ref_blocks.encode_int_column(ref_blocks.IntColumnData(v, m))
    assert meta["encoding"] == "value", meta
    return meta, s


def _str_value_block(rng, n, card, p_valid):
    meta, s = _str_block(rng, n, card, p_valid)
    assert meta["encoding"] == "value", meta
    return meta, s


def _v1_block(rng, n, card, p_valid, id_base_shift=0):
    """A bucket-v1 block, written as tests/test_storage.py writes one:
    cross-segment id deltas from an id_base meta, no seg_bases."""
    values = rng.integers(0, card, n).astype(np.int64)
    valid = rng.random(n) < p_valid
    rows = np.nonzero(valid)[0].astype(np.int64)
    order = np.argsort(values[rows], kind="stable")
    sorted_rows = rows[order]
    uniq, starts = np.unique(values[rows][order], return_index=True)
    offsets = np.empty(len(uniq) + 1, dtype=np.int32)
    offsets[:-1] = starts
    offsets[-1] = len(sorted_rows)
    deltas = np.empty(len(sorted_rows), dtype=np.int64)
    deltas[0] = 0
    deltas[1:] = sorted_rows[1:] - sorted_rows[:-1]
    meta = {"type": "int", "encoding": "bucket", "num_records": n,
            "cardinality": len(uniq),
            "id_base": int(sorted_rows[0]) + id_base_shift, "version": 1}
    return meta, {"uniq": uniq.astype(np.int64), "offsets": offsets,
                  "id_deltas": ref_blocks._narrow(deltas)}


def _b5_case(name, rng):
    """-> (list of (meta, sections) or None, C, expected kinds)."""
    if name == "value-i8-deltas":
        return [_value_block(rng, 8192, 1, 100, 1 << 40),
                _value_block(rng, 6000, 1, 120, -(1 << 41))], 8192, "i1"
    if name == "value-i16-deltas":
        return [_value_block(rng, 8192, -3000, 30000, 1_755_000_000),
                _value_block(rng, 8192, 1, 100, 0, 0.8)], 8192, "i2"
    if name == "value-i32-deltas":
        # unix timestamps: a large base, int32 steps, invalid rows
        return [_value_block(rng, 8192, -2_000_000, 2_000_000,
                             1_755_000_000, 0.7),
                _value_block(rng, 5500, 1, 100, 5)], 8192, "i4"
    if name == "value-i64-deltas":
        return [_value_block(rng, 8192, -(1 << 40), 1 << 40, 1 << 50),
                _value_block(rng, 8000, 1, 100, -7, 0.75)], 8192, "i8"
    if name == "value-short-and-missing":
        return [None, _value_block(rng, 5100, 1, 50, 1 << 33, 0.99), None,
                _value_block(rng, 8000, -40, 90, -(1 << 35), 0.9)], 8192, \
            None
    if name == "str-value-6000":
        return [_str_value_block(rng, 8192, 6000, 0.9),
                _str_value_block(rng, 7000, 6000, 0.97), None], 8192, None
    if name == "bucket-v1":
        return [_v1_block(rng, 1000, 7, 0.9), _v1_block(rng, 1024, 300, 0.6),
                _v1_block(rng, 700, 2, 1.0)], 1024, None
    if name == "bucket-v1-shifted-ids":
        # an id_base that pushes ids below 0 and past C: dropped rows
        return [_v1_block(rng, 1024, 9, 0.8, id_base_shift=-100),
                _v1_block(rng, 1024, 4, 0.9, id_base_shift=300)], 1024, None
    if name == "mixed-kinds":
        return [_value_block(rng, 8192, 1, 100, 1 << 40, 0.9),
                _int_block(rng, 8192, 12, 0.9), None,
                _v1_block(rng, 6000, 20, 0.8),
                _str_value_block(rng, 8192, 6000, 0.9),
                _value_block(rng, 8000, -3000, 30000, -5, 0.95), None,
                _str_block(rng, 3000, 40, 0.9)], 8192, None
    raise KeyError(name)


B5_CASES = ["value-i8-deltas", "value-i16-deltas", "value-i32-deltas",
            "value-i64-deltas", "value-short-and-missing", "str-value-6000",
            "bucket-v1", "bucket-v1-shifted-ids", "mixed-kinds"]


@pytest.mark.parametrize("name", B5_CASES)
def test_decode_other_encodings_match_reference(tmp_path, name):
    """Value, str-value, v1-bucket and mixed batches: the port's batch
    equals the reference's word for word over the whole [B, C],
    padding rows included (a value block's rows past its records hold
    the carried last value)."""
    rng = np.random.default_rng(100 + B5_CASES.index(name))
    encoded, C, dt = _b5_case(name, rng)
    containers = [None if e is None else _container(tmp_path, f"b{i}", *e)
                  for i, e in enumerate(encoded)]
    if dt is not None:
        wide = np.result_type(*[c.read("deltas").dtype
                                for c in containers if c is not None])
        assert wide == np.dtype(dt)
    rv, rm, rn = ref_decode(containers, C)
    pv, pm, pn = decode_column_batch(containers, C, "cpu")
    assert pn == rn
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    if name.startswith("value") or name == "mixed-kinds":
        kinds = [c.meta["encoding"] if c is not None else None
                 for c in containers]
        assert "value" in kinds


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


@pytest.mark.parametrize("name", list(chip_smoke.K6_CASES))
def test_id_mode_case_matches_reference(name):
    """K6's id mode on chip_smoke.py's K6 cases (the card runs the same
    cases through the kernel): decode_ids_plain against _decode_ids_jit
    on the case's str-id batch, and the whole column batch, -1 and -2
    rows and a value-mode launch included, against the reference's
    reassembly.  Tolerance 0."""
    containers, C = chip_smoke.k6_case(name)
    kinds, _ = port_decode.classify_containers(containers, C)
    idx = [i for i, k in enumerate(kinds) if k == "str_value"]
    ids, bits = port_decode.ids_batch(containers, idx, C)
    rv, rm = ref_decode_mod._decode_ids_jit(C, jnp.asarray(ids),
                                            jnp.asarray(bits))
    src = torch.arange(len(idx), dtype=torch.int32)
    pv, pm = port_decode.decode_ids_plain(torch.from_numpy(ids),
                                          torch.from_numpy(bits), src, C)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    rv, rm, rn = ref_decode(containers, C)
    pv, pm, pn = decode_column_batch(containers, C, "cpu")
    assert pn == rn
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    if name == "negative ids":
        assert (pv.numpy() < 0).any()
    if name == "all rows invalid":
        assert not pm.numpy().any()


# the deltas' type each K1 case is named for
_K1_DTYPES = {"uint8 deltas": np.uint8, "uint16 deltas": np.uint16,
              "int32 deltas": np.int32, "int8 deltas": np.int8,
              "int16 deltas": np.int16, "int64 deltas": np.int64}


@pytest.mark.parametrize("name", list(chip_smoke.K1_CASES))
def test_bucket2_case_matches_reference(name):
    """K1 on chip_smoke.py's K1 cases (the card holds the kernel to its
    plain version on the same cases): decode_bucket2_plain and
    decode_bucket_v1_plain against _decode_bucket2_jit and
    _decode_bucket_jit on the case's v2 and v1 blocks, the rows of a
    missing block zeroed and the rows of another launch left as they
    were; and the whole column batch against the reference's reassembly.
    Tolerance 0."""
    containers, C = chip_smoke.k1_case(name)
    B = len(containers)
    launched = 0
    for kind, plain, ref_fn in (
            ("bucket2", port_decode.decode_bucket2_plain,
             ref_decode_mod._decode_bucket2_jit),
            ("bucket", port_decode.decode_bucket_v1_plain,
             ref_decode_mod._decode_bucket_jit)):
        ins = chip_smoke.k1_layout_inputs(containers, kind)
        if ins is None:
            continue
        launched += 1
        *arrays, src = ins
        if name in _K1_DTYPES:
            assert arrays[0].dtype == _K1_DTYPES[name]
        if name == "K at the 8,192 cap":
            assert arrays[3].shape[1] == port_decode.MAX_K
        rv, rm = ref_fn(C, *[jnp.asarray(x) for x in arrays])
        rv, rm = np.asarray(rv), np.asarray(rm)
        out = (torch.full((B, C), 5, dtype=torch.int64),
               torch.ones((B, C), dtype=torch.bool))
        pv, pm = plain(*[torch.from_numpy(x) for x in arrays],
                       torch.from_numpy(src), C, out=out)
        pv, pm = pv.numpy(), pm.numpy()
        for i, j in enumerate(src):
            if j >= 0:
                np.testing.assert_array_equal(pv[i], rv[j])
                np.testing.assert_array_equal(pm[i], rm[j])
            elif j == port_decode.ZERO_ROW:
                assert not pv[i].any() and not pm[i].any()
            else:
                assert (pv[i] == 5).all() and pm[i].all()
        if name == "ids outside [0, C)":
            counts = arrays[1]
            assert rm.sum() < counts.sum()
    # a launch for each layout among the case's bucket blocks
    assert launched == len({b[0] for b in chip_smoke.K1_CASES[name][0]
                            if b is not None and b[0] in ("v2", "v1")})
    rv, rm, rn = ref_decode(containers, C)
    pv, pm, pn = decode_column_batch(containers, C, "cpu")
    assert pn == rn
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("name", list(chip_smoke.K6V_CASES))
def test_value_mode_case_matches_reference(name):
    """K6's value mode on chip_smoke.py's K6V cases (the card holds the
    kernel to its plain version on the same cases): decode_value_plain
    into a poisoned output against _decode_value_jit on the case's
    blocks; a row of a block gets its block's values and validity, a -1
    row is zeroed and a -2 row keeps the poison.  Tolerance 0."""
    deltas, bits, bases, src, C = chip_smoke.k6v_case(name)
    assert str(deltas.dtype) == chip_smoke.K6V_CASES[name]["dtype"]
    rv, rm = ref_decode_mod._decode_value_jit(
        C, jnp.asarray(deltas), jnp.asarray(bits), jnp.asarray(bases))
    rv, rm = np.asarray(rv), np.asarray(rm)
    B = len(src)
    out = (torch.full((B, C), 5, dtype=torch.int64),
           torch.ones((B, C), dtype=torch.bool))
    pv, pm = port_decode.decode_value_plain(
        *[torch.from_numpy(x) for x in (deltas, bits, bases, src)], C,
        out=out)
    pv, pm = pv.numpy(), pm.numpy()
    for i, j in enumerate(src):
        if j >= 0:
            np.testing.assert_array_equal(pv[i], rv[j])
            np.testing.assert_array_equal(pm[i], rm[j])
        elif j == port_decode.ZERO_ROW:
            assert not pv[i].any() and not pm[i].any()
        else:
            assert (pv[i] == 5).all() and pm[i].all()
    if name == "all entries invalid":
        assert not rm.any()
    if name == "int64 deltas that wrap":
        # the running sum passes 2^63 at least once
        wide = bases[:, None].astype(object) + np.cumsum(
            deltas.astype(object), axis=1)
        assert any(abs(x) >= 2 ** 63 for x in wide.reshape(-1)[::97])
