"""Device-side block decode.

Port of sybil_tpu/ops/decode.py.  The host mmaps the containers, pads
the ragged per-block sections into batch arrays (the reference's padding
rules: pow2 P and K, offsets padded with 2**31-1, deltas widened to
their common result type, value and id lanes zero-padded to C) and hands
them to one kernel launch per encoding present in the batch:

K1 decode_bucket2  bucket containers, both layouts: v2 (within-segment
                   posting deltas + per-segment first-row bases) and v1
                   (cross-segment deltas + one id_base per block)
K6 decode_value    value containers: int64 cumsum of the deltas + the
                   block's base; str-value containers (a str column past
                   CARDINALITY_THRESHOLD distinct values a block):
                   widened int32 dict ids, in a kernel of their own;
                   validity bit-unpacked in both modes

Every kernel writes int64 values and bool validity straight into the
rows of the [B, C] batch that hold its blocks, through a row -> block
map (src_of_row): rows of other encodings are left alone, and the rows
of blocks that lack the column are zeroed by exactly one launch.  So no
gather reassembles block order afterwards (the reference's lines
247-258).  Shapes the reference hands to the host decoder raise
ValueError.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

# delta / id dtypes the kernels read as they are; any other integer
# dtype is widened to int64 on the host, which keeps every bit the
# kernels use (the reference's int32 or int64 casts)
_DTYPE_CODE = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
               np.dtype(np.int32): 2, np.dtype(np.int8): 3,
               np.dtype(np.int16): 4, np.dtype(np.int64): 5}
_TORCH_CODE = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2,
               torch.int8: 3, torch.int16: 4, torch.int64: 5}
# offsets, seg_bases and uniq of one block stay in shared memory
MAX_K = 8192
# src_of_row codes: a row whose block lacks the column (zeroed by this
# launch), and a row that another launch writes (left alone)
ZERO_ROW = -1
OTHER_ROW = -2
# K1: the largest C its row ranges take (each range's rows staged in
# shared memory), and the paths its `paths` counts: v2 units whose first
# segment began in an earlier unit, and units whose look-back read more
# than one earlier unit's word
K1_MAX_C = 1 << 19
K1_PATHS = ("cut segment", "look-back past one unit")
# K6's value mode: entries a tile of its look-back (V_TILE in the source)
K6_TILE = 4096


def _pad_pow2(n: int, floor: int = 128) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def _kernel_dtype(arrays: list) -> np.dtype:
    wide = np.result_type(*[a.dtype for a in arrays])
    return wide if wide in _DTYPE_CODE else np.dtype(np.int64)


def _scatter_rows(block_v, block_m, src_of_row, out):
    """Plain scatter of per-block decodes [b, C] into the batch rows:
    src >= 0 copies its block, ZERO_ROW zeroes, OTHER_ROW is left."""
    values, valid = out
    rows = torch.nonzero(src_of_row >= 0).reshape(-1)
    if rows.numel():
        src = src_of_row[rows].to(torch.int64)
        values[rows] = block_v[src]
        valid[rows] = block_m[src]
    zero = torch.nonzero(src_of_row == ZERO_ROW).reshape(-1)
    values[zero] = 0
    valid[zero] = False
    return values, valid


def _outputs(out, B: int, C: int, dev):
    if out is not None:
        values, valid = out
        if (values.shape != (B, C) or values.dtype != torch.int64
                or valid.shape != (B, C) or valid.dtype != torch.bool
                or values.device != dev or valid.device != dev
                or not values.is_contiguous() or not valid.is_contiguous()):
            raise ValueError(f"decode: out must be contiguous int64 and bool "
                             f"[{B}, {C}] tensors on {dev}")
        return values, valid
    return (torch.empty((B, C), dtype=torch.int64, device=dev),
            torch.empty((B, C), dtype=torch.bool, device=dev))


def _check_inputs(kernel: str, want, dev) -> None:
    for t, dt, shape in want:
        if (t.device != dev or (dt is not None and t.dtype != dt)
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{kernel}: expected a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _check_C(kernel: str, C: int) -> None:
    if C < 128 or C & (C - 1):
        raise ValueError(f"{kernel}: C must be a power of two >= 128, "
                         f"got {C}")


def _unpack_bits(bits, C: int):
    """Little-endian bit-unpack [b, C/8] uint8 -> bool [b, C]."""
    sh = torch.arange(8, dtype=torch.uint8, device=bits.device)
    unpacked = (bits[:, :, None] >> sh[None, None, :]) & 1
    return unpacked.reshape(bits.shape[0], -1)[:, :C] > 0


# ---------------------------------------------------------------------------
# K1 decode_bucket2 (v2 and v1 layouts)
# ---------------------------------------------------------------------------

def _bucket_plain(deltas, counts, offsets, uniq, row_ids, src_of_row, C,
                  out):
    """Shared tail of the two bucket layouts: each live posting p of
    block j writes uniq[slot] at row_ids[j, p] when 0 <= id < C."""
    dev = deltas.device
    b, P = deltas.shape
    K = uniq.shape[1]
    B = src_of_row.shape[0]
    p = torch.arange(P, dtype=torch.int32, device=dev)
    live = p[None, :] < counts[:, None]
    val_idx = torch.searchsorted(offsets, p.expand(b, P).contiguous(),
                                 right=True)
    vals = torch.gather(uniq, 1, val_idx.clamp(0, K - 1))
    ok = live & (row_ids >= 0) & (row_ids < C)
    tgt = torch.where(ok, torch.arange(b, device=dev)[:, None] * C
                      + row_ids, b * C).reshape(-1)
    block_v = torch.zeros(b * C + 1, dtype=torch.int64, device=dev)
    block_v[tgt] = vals.reshape(-1)
    block_m = torch.zeros(b * C + 1, dtype=torch.bool, device=dev)
    block_m[tgt] = True
    out = _outputs(out, B, C, dev)
    return _scatter_rows(block_v[: b * C].reshape(b, C),
                         block_m[: b * C].reshape(b, C), src_of_row, out)


def _segment_starts(deltas, offsets, P: int, K: int):
    """Per posting: its segment's slot and the inclusive cumsum (int32,
    wrapping) at the segment's first posting."""
    dev = deltas.device
    b = deltas.shape[0]
    cum = torch.cumsum(deltas.to(torch.int32), dim=1, dtype=torch.int32)
    p = torch.arange(P, dtype=torch.int32, device=dev)
    val_idx = torch.searchsorted(offsets, p.expand(b, P).contiguous(),
                                 right=True)
    start_pos = torch.where(
        val_idx > 0,
        torch.gather(offsets, 1, (val_idx - 1).clamp(0, K - 1)),
        0).to(torch.int64)
    return cum, val_idx, torch.gather(cum, 1, start_pos.clamp(0, P - 1))


def decode_bucket2_plain(deltas, counts, offsets, uniq, seg_bases,
                         src_of_row, C: int, out=None):
    """Plain PyTorch version of K1, v2 layout (cumsum / searchsorted /
    scatter)."""
    P, K = deltas.shape[1], uniq.shape[1]
    cum, val_idx, cum_at_start = _segment_starts(deltas, offsets, P, K)
    ids = (torch.gather(seg_bases, 1, val_idx.clamp(0, K - 1)) + cum
           - cum_at_start)
    return _bucket_plain(deltas, counts, offsets, uniq, ids, src_of_row, C,
                         out)


def decode_bucket_v1_plain(deltas, counts, offsets, uniq, id_bases,
                           src_of_row, C: int, out=None):
    """Plain PyTorch version of K1, v1 layout: ids = int32 cumsum of the
    cross-segment deltas + the block's id_base (int32, wrapping)."""
    cum = torch.cumsum(deltas.to(torch.int32), dim=1, dtype=torch.int32)
    ids = cum + id_bases[:, None]
    return _bucket_plain(deltas, counts, offsets, uniq, ids, src_of_row, C,
                         out)


def _launch_k1(v1: bool, deltas, counts, offsets, uniq, bases, src_of_row,
               C: int, out, paths):
    dev = deltas.device
    kernel = "decode_bucket_v1" if v1 else "decode_bucket2"
    b, P = deltas.shape
    K = uniq.shape[1]
    B = src_of_row.shape[0]
    _check_inputs(kernel, [
        (deltas, None, (b, P)), (counts, torch.int32, (b,)),
        (offsets, torch.int32, (b, K)), (uniq, torch.int64, (b, K)),
        (bases, torch.int32, (b,) if v1 else (b, K)),
        (src_of_row, torch.int32, (B,))], dev)
    if deltas.dtype not in _TORCH_CODE:
        raise ValueError(f"{kernel}: deltas must be one of "
                         f"{sorted(map(str, _TORCH_CODE))}, got {deltas.dtype}")
    _check_C(kernel, C)
    if K > MAX_K:
        raise ValueError(f"{kernel}: K must be <= {MAX_K}, got {K}")
    if C > K1_MAX_C:
        raise ValueError(f"{kernel}: C must be <= {K1_MAX_C}, got {C}")
    if paths is not None:
        _check_inputs(kernel, [(paths, torch.int64, (len(K1_PATHS),))], dev)
    values, valid = _outputs(out, B, C, dev)
    if B == 0:
        return values, valid
    # the ticket and look-back status words (zeroed by the C entry), the
    # postings by row range and their counts
    size = kernels.entry("decode_bucket2", "decode_bucket2_scratch",
                         [ctypes.c_int] * 3, ctypes.c_longlong)
    scratch = torch.empty(size(B, P, C), dtype=torch.int64, device=dev)
    fn = kernels.entry("decode_bucket2", "decode_bucket2",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    kernels.check(fn(deltas.data_ptr(), _TORCH_CODE[deltas.dtype], int(v1),
                     counts.data_ptr(), offsets.data_ptr(), uniq.data_ptr(),
                     bases.data_ptr(), src_of_row.data_ptr(),
                     values.data_ptr(), valid.data_ptr(),
                     scratch.data_ptr(),
                     0 if paths is None else paths.data_ptr(), B, P, K, C,
                     kernels.stream_handle(dev)), kernel)
    kernels.LAUNCHES["decode_bucket2"] += 1
    return values, valid


def decode_bucket2(deltas, counts, offsets, uniq, seg_bases, src_of_row,
                   C: int, out=None, paths=None):
    """K1, v2 layout: -> (values int64 [B, C], valid bool [B, C]).

    deltas [b, P] (u8/u16/i32/i8/i16/i64; the cumsum takes their int32
    cast); counts i32 [b]; offsets i32 [b, K] (CSR offsets[1:], padded
    with 2**31-1); uniq i64 [b, K]; seg_bases i32 [b, K]; src_of_row i32
    [B]: the block (row of the b inputs) of each output row, ZERO_ROW
    for a missing block, OTHER_ROW for a row another launch writes.
    out: optional (values, valid) to write in place.  paths: an int64 [2]
    CUDA tensor to which the launch adds the units that took each of
    K1_PATHS, or None.  CUDA tensors launch csrc/decode_bucket2.cu; CPU
    tensors take decode_bucket2_plain.

    Replaces sybil_tpu/ops/decode.py:_decode_bucket2_jit and its
    reassembly gather.  Bound by memory (9 B written per output row);
    units of 2,048 postings, many a block, find each posting's row (a
    decoupled look-back carries a segment's sum across units) and sort
    them by row range, then a CTA a row range gathers them in shared
    memory and writes the range whole (see the source note)."""
    if deltas.device.type == "cpu":
        return decode_bucket2_plain(deltas, counts, offsets, uniq,
                                    seg_bases, src_of_row, C, out)
    if deltas.device.type != "cuda":
        raise ValueError(f"decode_bucket2: unsupported device "
                         f"{deltas.device}")
    return _launch_k1(False, deltas, counts, offsets, uniq, seg_bases,
                      src_of_row, C, out, paths)


def decode_bucket_v1(deltas, counts, offsets, uniq, id_bases, src_of_row,
                     C: int, out=None, paths=None):
    """K1, v1 layout: as decode_bucket2, with id_bases i32 [b] (each
    block's meta id_base, cast to int32) in place of seg_bases; ids
    outside [0, C) (cross-segment cumsums can go negative) are dropped.
    CUDA tensors launch csrc/decode_bucket2.cu in its v1 mode; CPU
    tensors take decode_bucket_v1_plain.

    Replaces sybil_tpu/ops/decode.py:_decode_bucket_jit and its
    reassembly gather."""
    if deltas.device.type == "cpu":
        return decode_bucket_v1_plain(deltas, counts, offsets, uniq,
                                      id_bases, src_of_row, C, out)
    if deltas.device.type != "cuda":
        raise ValueError(f"decode_bucket_v1: unsupported device "
                         f"{deltas.device}")
    return _launch_k1(True, deltas, counts, offsets, uniq, id_bases,
                      src_of_row, C, out, paths)


# ---------------------------------------------------------------------------
# K6 decode_value (value and str-id modes)
# ---------------------------------------------------------------------------

def decode_value_plain(deltas, bits, bases, src_of_row, C: int, out=None):
    """Plain PyTorch version of K6, value mode: int64 cumsum (wrapping)
    of the deltas + base, bit-unpacked validity."""
    values = torch.cumsum(deltas.to(torch.int64), dim=1) + bases[:, None]
    out = _outputs(out, src_of_row.shape[0], C, deltas.device)
    return _scatter_rows(values, _unpack_bits(bits, C), src_of_row, out)


def decode_ids_plain(ids, bits, src_of_row, C: int, out=None):
    """Plain PyTorch version of K6, str-id mode: widened int32 dict ids,
    bit-unpacked validity."""
    out = _outputs(out, src_of_row.shape[0], C, ids.device)
    return _scatter_rows(ids.to(torch.int64), _unpack_bits(bits, C),
                         src_of_row, out)


def _launch_k6(ids_mode: bool, lanes, bits, bases, src_of_row, C: int, out):
    dev = lanes.device
    kernel = "decode_ids" if ids_mode else "decode_value"
    b = lanes.shape[0]
    B = src_of_row.shape[0]
    _check_C(kernel, C)
    want = [(lanes, torch.int32 if ids_mode else None, (b, C)),
            (bits, torch.uint8, (b, C // 8)),
            (src_of_row, torch.int32, (B,))]
    if not ids_mode:
        want.append((bases, torch.int64, (b,)))
    _check_inputs(kernel, want, dev)
    if lanes.dtype not in _TORCH_CODE:
        raise ValueError(f"{kernel}: deltas must be one of "
                         f"{sorted(map(str, _TORCH_CODE))}, got {lanes.dtype}")
    values, valid = _outputs(out, B, C, dev)
    if B == 0:
        return values, valid
    # both modes' 16-byte loads and stores
    if (lanes.data_ptr() | values.data_ptr()) % 16 or valid.data_ptr() % 4:
        raise ValueError(f"{kernel}: the {'ids' if ids_mode else 'deltas'} "
                         f"and values must be 16-byte aligned, valid "
                         f"4-byte aligned")
    if ids_mode:
        fn = kernels.entry("decode_value", "decode_ids",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
        rc = fn(lanes.data_ptr(), bits.data_ptr(), src_of_row.data_ptr(),
                values.data_ptr(), valid.data_ptr(), B, C,
                kernels.stream_handle(dev))
    else:
        # the look-back's ticket, then a flag, a total and a prefix word a
        # tile of K6_TILE entries (a row of fewer is one tile); the C
        # entry's memset clears them
        status = torch.empty(1 + 3 * B * max(1, C // K6_TILE),
                             dtype=torch.int64, device=dev)
        fn = kernels.entry("decode_value", "decode_value",
                           [ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_void_p] * 6
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
        rc = fn(lanes.data_ptr(), _TORCH_CODE[lanes.dtype], bits.data_ptr(),
                bases.data_ptr(), src_of_row.data_ptr(), values.data_ptr(),
                valid.data_ptr(), status.data_ptr(), status.numel(), B, C,
                kernels.stream_handle(dev))
    kernels.check(rc, kernel)
    kernels.LAUNCHES["decode_value"] += 1
    kernels.FORMS["decode_value ids" if ids_mode else "decode_value values"] \
        += 1
    return values, valid


def decode_value(deltas, bits, bases, src_of_row, C: int, out=None):
    """K6, value mode: -> (values int64 [B, C], valid bool [B, C]).

    deltas [b, C] (u8/u16/i32/i8/i16/i64, zero-padded past each block's
    records, so the cumsum carries the last value through the padding);
    bits u8 [b, C/8] little-endian validity; bases i64 [b]; src_of_row
    and out as for decode_bucket2.  CUDA tensors launch
    csrc/decode_value.cu; CPU tensors take decode_value_plain.

    Replaces sybil_tpu/ops/decode.py:_decode_value_jit and its
    reassembly gather.  Bound by memory (the deltas and bits read, 9 B
    written per row); a flat grid of 4,096-entry tiles, a thread's quads
    of 4 consecutive entries read and written in 16-byte accesses, the
    carry between a row's tiles by a decoupled look-back after one memset
    (see the source note)."""
    if deltas.device.type == "cpu":
        return decode_value_plain(deltas, bits, bases, src_of_row, C, out)
    if deltas.device.type != "cuda":
        raise ValueError(f"decode_value: unsupported device {deltas.device}")
    return _launch_k6(False, deltas, bits, bases, src_of_row, C, out)


def decode_ids(ids, bits, src_of_row, C: int, out=None):
    """K6, str-id mode: ids i32 [b, C] (zero-padded), bits u8 [b, C/8];
    otherwise as decode_value.  CUDA tensors launch csrc/decode_value.cu
    in its id mode; CPU tensors take decode_ids_plain.

    Replaces sybil_tpu/ops/decode.py:_decode_ids_jit and its reassembly
    gather.  Bound by memory (4 B of ids and 1/8 B of bits read, 9 B
    written an entry); a flat grid over quads of the output, a 16-byte
    load of ids and 16-byte stores of values a quad (see the source
    note)."""
    if ids.device.type == "cpu":
        return decode_ids_plain(ids, bits, src_of_row, C, out)
    if ids.device.type != "cuda":
        raise ValueError(f"decode_ids: unsupported device {ids.device}")
    return _launch_k6(True, ids, bits, None, src_of_row, C, out)


# ---------------------------------------------------------------------------
# host batch assembly (the reference's padding rules)
# ---------------------------------------------------------------------------

def _bucket_common(containers: list, idx: list[int]):
    b = len(idx)
    dts = [containers[i].read("id_deltas") for i in idx]
    P = _pad_pow2(max((len(d) for d in dts), default=1))
    K = _pad_pow2(max((len(containers[i].read("uniq"))
                       for i in idx), default=1), floor=8)
    deltas = np.zeros((b, P), dtype=_kernel_dtype(dts))
    counts = np.zeros(b, dtype=np.int32)
    offsets = np.full((b, K), 2**31 - 1, dtype=np.int32)
    uniq = np.zeros((b, K), dtype=np.int64)
    for j, i in enumerate(idx):
        c = containers[i]
        d = dts[j]
        deltas[j, : len(d)] = d
        counts[j] = len(d)
        off = c.read("offsets")
        offsets[j, : len(off) - 1] = off[1:]
        u = c.read("uniq")
        uniq[j, : len(u)] = u
    return deltas, counts, offsets, uniq


def bucket2_batch(containers: list, idx: list[int]):
    """Bucket-v2 containers at `idx` -> numpy (deltas, counts, offsets,
    uniq, seg_bases)."""
    deltas, counts, offsets, uniq = _bucket_common(containers, idx)
    seg_bases = np.zeros(uniq.shape, dtype=np.int32)
    for j, i in enumerate(idx):
        sb = containers[i].read("seg_bases")
        seg_bases[j, : len(sb)] = sb
    return deltas, counts, offsets, uniq, seg_bases


def bucket_v1_batch(containers: list, idx: list[int]):
    """Bucket-v1 containers at `idx` -> numpy (deltas, counts, offsets,
    uniq, id_bases int32 [b]: the meta id_base, cast as the reference's
    int32 add does)."""
    deltas, counts, offsets, uniq = _bucket_common(containers, idx)
    bases = np.array([containers[i].meta.get("id_base", 0) for i in idx],
                     dtype=np.int64).astype(np.int32)
    return deltas, counts, offsets, uniq, bases


def _bits(containers: list, idx: list[int], C: int) -> np.ndarray:
    bits = np.zeros((len(idx), C // 8 + (1 if C % 8 else 0)), dtype=np.uint8)
    for j, i in enumerate(idx):
        vb = containers[i].read("valid_bits")
        bits[j, : len(vb)] = vb
    return bits


def value_batch(containers: list, idx: list[int], C: int):
    """Value containers at `idx` -> numpy (deltas [b, C] in the blocks'
    common result type, zero-padded; bits [b, C/8]; bases int64 [b])."""
    dts = [containers[i].read("deltas") for i in idx]
    deltas = np.zeros((len(idx), C), dtype=_kernel_dtype(dts))
    for j, d in enumerate(dts):
        deltas[j, : len(d)] = d
    bases = np.array([containers[i].meta.get("base", 0) for i in idx],
                     dtype=np.int64)
    return deltas, _bits(containers, idx, C), bases


def ids_batch(containers: list, idx: list[int], C: int):
    """Str-value containers at `idx` -> numpy (ids int32 [b, C],
    zero-padded; bits [b, C/8])."""
    ids = np.zeros((len(idx), C), dtype=np.int32)
    for j, i in enumerate(idx):
        d = containers[i].read("ids")
        ids[j, : len(d)] = d
    return ids, _bits(containers, idx, C)


def classify_containers(containers: list, C: int):
    """-> (kinds, ncols) of a column's containers, one per block in
    order: kinds[i] in {"bucket2", "bucket", "value", "str_value",
    "missing"}, ncols[i] the block's num_records (-1 when missing).
    Raises ValueError for shapes the reference also hands to the host
    decoder."""
    ncols = []
    kinds = []
    for c in containers:
        if c is None:
            kinds.append("missing")
            ncols.append(-1)
            continue
        enc = c.meta.get("encoding")
        typ = c.meta.get("type")
        ncols.append(int(c.meta["num_records"]))
        if enc == "value" and typ == "int":
            kinds.append("value")
        elif enc == "bucket" and typ in ("int", "str"):
            kinds.append("bucket2" if "seg_bases" in c else "bucket")
        elif enc == "value" and typ == "str":
            kinds.append("str_value")
        else:
            raise ValueError(f"unsupported encoding {typ}/{enc}")
        if ncols[-1] > C:
            raise ValueError("block larger than batch chunk")
    return kinds, ncols


def decode_column_batch(containers: list, C: int, device):
    """Decode one column across a batch of blocks on `device`.

    containers: list of codec.Container or None (block lacks the column),
    in block order.  Returns (values int64 [B, C], valid bool [B, C],
    ncols tuple) — ncols[i] is the block's num_records, -1 when missing.
    One launch per encoding present; the first zeroes the missing rows.
    Raises as classify_containers does."""
    B = len(containers)
    kinds, ncols = classify_containers(containers, C)
    device = torch.device(device)
    present = [k for k in ("bucket2", "bucket", "value", "str_value")
               if k in kinds]
    if not present:
        return (torch.zeros((B, C), dtype=torch.int64, device=device),
                torch.zeros((B, C), dtype=torch.bool, device=device),
                tuple(ncols))
    out = (torch.empty((B, C), dtype=torch.int64, device=device),
           torch.empty((B, C), dtype=torch.bool, device=device))

    def to_dev(*arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    for n, kind in enumerate(present):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        src = np.full(B, ZERO_ROW if n == 0 else OTHER_ROW, dtype=np.int32)
        src[[i for i, k in enumerate(kinds) if k != "missing"]] = OTHER_ROW
        src[idx] = np.arange(len(idx), dtype=np.int32)
        if kind == "bucket2":
            args = to_dev(*bucket2_batch(containers, idx), src)
            decode_bucket2(*args, C, out=out)
        elif kind == "bucket":
            args = to_dev(*bucket_v1_batch(containers, idx), src)
            decode_bucket_v1(*args, C, out=out)
        elif kind == "value":
            args = to_dev(*value_batch(containers, idx, C), src)
            decode_value(*args, C, out=out)
        else:
            args = to_dev(*ids_batch(containers, idx, C), src)
            decode_ids(*args, C, out=out)
    return out[0], out[1], tuple(ncols)
