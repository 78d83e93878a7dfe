"""Device-side block decode.

Port of sybil_tpu/ops/decode.py.  The host mmaps the containers, pads
the ragged per-block sections into batch arrays (pow2 P and K, offsets
padded with 2**31-1, deltas widened to their common result type) and
hands them to one kernel launch per column:

K1 decode_bucket2  bucket-v2 containers (within-segment posting deltas
                   + per-segment first-row bases) -> int64 values and
                   bool validity [B, C], each block written straight
                   into its row of the batch through a row -> block
                   map; rows of blocks that lack the column are zeros

The value, str-value and v1-bucket encodings are not ported yet
(ROADMAP B5) and raise NotImplementedError; shapes the reference itself
hands to the host decoder still raise ValueError.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

_DTYPE_CODE = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
               np.dtype(np.int32): 2}
_TORCH_CODE = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
# offsets, seg_bases and uniq of one block stay in shared memory
MAX_K = 8192


def _pad_pow2(n: int, floor: int = 128) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def decode_bucket2_plain(deltas, counts, offsets, uniq, seg_bases,
                         src_of_row, C: int):
    """Plain PyTorch version of K1 (cumsum / searchsorted / scatter)."""
    dev = deltas.device
    b, P = deltas.shape
    K = uniq.shape[1]
    B = src_of_row.shape[0]
    cum = torch.cumsum(deltas.to(torch.int32), dim=1, dtype=torch.int32)
    p = torch.arange(P, dtype=torch.int32, device=dev)
    live = p[None, :] < counts[:, None]
    val_idx = torch.searchsorted(offsets, p.expand(b, P).contiguous(),
                                 right=True)
    start_pos = torch.where(
        val_idx > 0,
        torch.gather(offsets, 1, (val_idx - 1).clamp(0, K - 1)),
        0).to(torch.int64)
    cum_at_start = torch.gather(cum, 1, start_pos.clamp(0, P - 1))
    vi = val_idx.clamp(0, K - 1)
    ids = torch.gather(seg_bases, 1, vi) + cum - cum_at_start
    vals = torch.gather(uniq, 1, vi)
    rows = torch.nonzero(src_of_row >= 0).reshape(-1)
    row_of = torch.zeros(b, dtype=torch.int64, device=dev)
    row_of[src_of_row[rows].to(torch.int64)] = rows
    tgt = torch.where(live & (ids >= 0) & (ids < C),
                      row_of[:, None] * C + ids, B * C).reshape(-1)
    values = torch.zeros(B * C + 1, dtype=torch.int64, device=dev)
    values[tgt] = vals.reshape(-1)
    valid = torch.zeros(B * C + 1, dtype=torch.bool, device=dev)
    valid[tgt] = True
    return values[: B * C].reshape(B, C), valid[: B * C].reshape(B, C)


def decode_bucket2(deltas, counts, offsets, uniq, seg_bases, src_of_row,
                   C: int):
    """K1: -> (values int64 [B, C], valid bool [B, C]).

    deltas u8/u16/i32 [b, P]; counts i32 [b]; offsets i32 [b, K] (CSR
    offsets[1:], padded with 2**31-1); uniq i64 [b, K]; seg_bases i32
    [b, K]; src_of_row i32 [B] (block index into the b rows, -1 =
    missing block).  CUDA tensors launch csrc/decode_bucket2.cu; CPU
    tensors take decode_bucket2_plain.

    Replaces sybil_tpu/ops/decode.py:_decode_bucket2_jit and its
    reassembly gather.  Bound by memory (9 B written per output row);
    one CTA per output row zeroes the row and scatters its block's
    postings into it with a running block scan (see the source note)."""
    dev = deltas.device
    if dev.type == "cpu":
        return decode_bucket2_plain(deltas, counts, offsets, uniq,
                                    seg_bases, src_of_row, C)
    if dev.type != "cuda":
        raise ValueError(f"decode_bucket2: unsupported device {dev}")
    b, P = deltas.shape
    K = uniq.shape[1]
    B = src_of_row.shape[0]
    want = [(deltas, None, (b, P)), (counts, torch.int32, (b,)),
            (offsets, torch.int32, (b, K)), (uniq, torch.int64, (b, K)),
            (seg_bases, torch.int32, (b, K)),
            (src_of_row, torch.int32, (B,))]
    for t, dt, shape in want:
        if (t.device != dev or (dt is not None and t.dtype != dt)
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"decode_bucket2: expected a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if deltas.dtype not in _TORCH_CODE:
        raise ValueError(f"decode_bucket2: deltas must be u8/u16/i32, "
                         f"got {deltas.dtype}")
    if C < 128 or C & (C - 1) or K > MAX_K:
        raise ValueError(f"decode_bucket2: C must be a power of two >= 128 "
                         f"and K <= {MAX_K}, got C={C} K={K}")
    values = torch.empty((B, C), dtype=torch.int64, device=dev)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    if B == 0:
        return values, valid
    fn = kernels.lib("decode_bucket2").decode_bucket2
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kernels.check(fn(deltas.data_ptr(), _TORCH_CODE[deltas.dtype],
                     counts.data_ptr(), offsets.data_ptr(), uniq.data_ptr(),
                     seg_bases.data_ptr(), src_of_row.data_ptr(),
                     values.data_ptr(), valid.data_ptr(), B, P, K, C,
                     kernels.stream_handle(dev)), "decode_bucket2")
    kernels.LAUNCHES["decode_bucket2"] += 1
    return values, valid


def bucket2_batch(containers: list, idx: list[int]):
    """Host-side batch assembly of the bucket-v2 containers at `idx`
    (the reference's padding rules) -> numpy (deltas, counts, offsets,
    uniq, seg_bases)."""
    b = len(idx)
    dts = [containers[i].read("id_deltas") for i in idx]
    P = _pad_pow2(max((len(d) for d in dts), default=1))
    K = _pad_pow2(max((len(containers[i].read("uniq"))
                       for i in idx), default=1), floor=8)
    wide = np.result_type(*[d.dtype for d in dts])
    if wide not in _DTYPE_CODE:
        wide = np.dtype(np.int32)    # the kernel's cumsum is int32 anyway
    deltas = np.zeros((b, P), dtype=wide)
    counts = np.zeros(b, dtype=np.int32)
    offsets = np.full((b, K), 2**31 - 1, dtype=np.int32)
    uniq = np.zeros((b, K), dtype=np.int64)
    seg_bases = np.zeros((b, K), dtype=np.int32)
    for j, i in enumerate(idx):
        c = containers[i]
        d = dts[j]
        deltas[j, : len(d)] = d
        counts[j] = len(d)
        off = c.read("offsets")
        offsets[j, : len(off) - 1] = off[1:]
        u = c.read("uniq")
        uniq[j, : len(u)] = u
        sb = c.read("seg_bases")
        seg_bases[j, : len(sb)] = sb
    return deltas, counts, offsets, uniq, seg_bases


def classify_containers(containers: list, C: int):
    """-> (kinds, ncols) of a column's containers, one per block in
    order: kinds[i] in {"bucket2", "missing"}, ncols[i] the block's
    num_records (-1 when missing).  Raises ValueError for shapes the
    reference also hands to the host decoder, NotImplementedError for
    encodings whose device decode is not ported yet."""
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
    other = sorted({k for k in kinds if k not in ("bucket2", "missing")})
    if other:
        raise NotImplementedError(
            f"device decode of {'/'.join(other)} containers is not ported "
            f"yet (ROADMAP B5)")
    return kinds, ncols


def decode_column_batch(containers: list, C: int, device):
    """Decode one column across a batch of blocks on `device`.

    containers: list of codec.Container or None (block lacks the column),
    in block order.  Returns (values int64 [B, C], valid bool [B, C],
    ncols tuple) — ncols[i] is the block's num_records, -1 when missing.
    Raises as classify_containers does."""
    B = len(containers)
    kinds, ncols = classify_containers(containers, C)
    device = torch.device(device)
    idx = [i for i, k in enumerate(kinds) if k == "bucket2"]
    if not idx:
        return (torch.zeros((B, C), dtype=torch.int64, device=device),
                torch.zeros((B, C), dtype=torch.bool, device=device),
                tuple(ncols))
    arrays = bucket2_batch(containers, idx)
    src_of_row = np.full(B, -1, dtype=np.int32)
    src_of_row[idx] = np.arange(len(idx), dtype=np.int32)
    deltas, counts, offsets, uniq, seg_bases, src = (
        torch.from_numpy(a).to(device) for a in (*arrays, src_of_row))
    values, valid = decode_bucket2(deltas, counts, offsets, uniq, seg_bases,
                                   src, C)
    return values, valid, tuple(ncols)
