"""The mesh scan: data shards and the hash-partitioned shuffle.

Port of sybil_tpu/parallel/mesh.py.  A mesh has D data shards.  The
batch's blocks split into D contiguous shards, and one process holds the
D / nproc shards [pid * Dl, (pid + 1) * Dl) on its one device (all D on
one card with one process).  Per query batch:

  1. each shard scans its blocks up to the pack (ops/scan.py scan_core:
     K14, then K2 and K4, or K7, the sorts, K8 and K9), so a hot key is
     one row per shard by the time it reaches the wire;
  2. K15 shuffle_partition turns every local shard's group table into
     payload rows [keys | summed lanes | bucket counts | min | max] and
     places the live ones by key owner (a hash of the keys modulo D)
     into the shard's send buffer [D, Sc, WP], one launch over all the
     local shards;
  3. the exchange (Mesh.all_to_all) sends every row once, to its key's
     owner;
  4. the owners sort what they received by (owner, key) (K16's
     shuffle_keys compacts their live rows, the stable torch.sort passes
     of sort_rows) and K16 shuffle_reduce merges equal keys into at most
     Sc rows an owner, one call each over every local owner
     (merge_owners);
  5. the exchange gathers the owners' disjoint merged tables and their
     statistics to every process; K12 (two-valued) puts the live rows
     first, and K16's shuffle_unpack splits the final table into the
     keys, lanes, min/max and bucket counts K3's keyed form (dense) or
     K10 (sorted) packs (ops/scan.py pack_parts).
Row-level side outputs (outlier rows, sparse hist pairs, distinct pairs,
the matched mask) stay per shard and are joined in shard order, as the
reference's out_specs=P(axis) leaves them; with several processes they
are gathered, a dense scan's outlier rows compacted first with their keys
(_gather_outlier_rows).  A shuffle that overflows its per-owner capacity is counted
in the meta row and refused by the engine, never silently truncated.

The exchange's local form (one process) is a transpose of the send
buffers on the device; its distributed form is torch.distributed's
all_to_all_single and all_gather_into_tensor over the process group
(NCCL on cuda, gloo on cpu; parallel/multihost.py joins it).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import multihost
from ..ops import kernels
from ..ops.scan import (SENTINEL, Desc, ScanConfig, _batch_shape,
                        _check_tensor, _grid, _ptr, _ptr_fields, _set_desc,
                        _sm_count, dense_keys_np, hist_aggs, key_rows,
                        reduce_space, scan_core, sort_rows, sorted_perm,
                        topk_rows)

_BIG = 2 ** 62
_I64_MAX = 2 ** 63 - 1
_I64_MIN = -2 ** 63
_M32 = 0xFFFFFFFF
MAX_SHARDS = 256        # K15's shared per-owner counts


# ---------------------------------------------------------------------------
# the mesh and its exchange
# ---------------------------------------------------------------------------

class Mesh:
    """D data shards, this process's Dl of them, and the collectives of
    the shuffle over them (the exchange).  Local form (group None, one
    process holds every shard): a transpose on the device.  Distributed
    form: torch.distributed over `group`, process p holding shards
    [p * Dl, (p + 1) * Dl)."""

    def __init__(self, D: int, group=None):
        if not 1 <= D <= MAX_SHARDS:
            raise ValueError(f"data-shards must lie in [1, {MAX_SHARDS}], "
                             f"got {D}")
        self.D = D
        self.group = group
        if group is None:
            self.nproc, self.pid = 1, 0
        else:
            import torch.distributed as dist
            self.nproc = dist.get_world_size(group)
            self.pid = dist.get_rank(group)
        if D % self.nproc:
            raise ValueError(f"data-shards {D} must divide evenly across "
                             f"{self.nproc} processes")
        self.Dl = D // self.nproc

    def all_to_all(self, send):
        """send [Dl, D, Sc, WP] (row block [s, o] from local source shard
        s to owner o) -> [Dl, D * Sc, WP]: each local owner's received
        rows, the source shards' blocks in global shard order (the
        reference's all_to_all, mesh.py:276-278)."""
        Dl, D, Sc, WP = send.shape
        if self.group is None:
            return send.transpose(0, 1).reshape(D, D * Sc, WP)
        import torch.distributed as dist
        n = self.nproc
        # regroup by destination process: [proc, owner, source, Sc, WP]
        x = send.reshape(Dl, n, Dl, Sc, WP).permute(1, 2, 0, 3, 4)
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        # out[p, o, s]: from source shard p * Dl + s to local owner o
        return out.permute(1, 0, 2, 3, 4).reshape(Dl, D * Sc, WP)

    def all_gather(self, x):
        """[n, ...] of this process's shards -> [nproc * n, ...], every
        process's in global shard order (the reference's all_gather,
        mesh.py:286-287, and multihost.fetch of the row outputs)."""
        if self.group is None:
            return x
        return multihost.fetch(x, self.group)


# ---------------------------------------------------------------------------
# payload layout: [rows, WP] int64
#   [keys K | count, samples, (exists, acnt, awv)*A | hist lanes | amn*A |
#    amx*A]; the summed lanes are contiguous
# ---------------------------------------------------------------------------

def payload_spec(config: ScanConfig):
    """-> (K, A, hist_ais, nv_total, n_sum, WP).  Only the dense
    strategy's bucket matrices ride the payload; the sorted strategy's
    sparse hist pairs stay row-level (reference _payload_spec)."""
    K = config.n_key_cols
    A = len(config.aggs)
    hist_ais = hist_aggs(config) if config.strategy == "dense" else []
    nv_total = sum(config.aggs[ai].num_values for ai in hist_ais)
    n_sum = 2 + 3 * A + nv_total
    return K, A, hist_ais, nv_total, n_sum, K + n_sum + 2 * A


def shuffle_caps(config: ScanConfig, D: int) -> tuple[int, int]:
    """-> (Seff, Sc): the table rows that ride the shuffle and the
    per-owner capacity, 2x the fair share plus slack (mesh.py:259-262;
    the owner's merged table has the same capacity)."""
    Seff = config.table_slots
    return Seff, min(Seff, 2 * -(-Seff // D) + 128)


def n_stats(config: ScanConfig) -> int:
    """Words of a shard's statistics row: n_groups, spill, overflow, an
    outlier count and a hist pair count per histogram aggregation."""
    return 3 + 2 * len(hist_aggs(config))


# ---------------------------------------------------------------------------
# K15 shuffle_partition
# ---------------------------------------------------------------------------

def build_payload_plain(config: ScanConfig, part: dict):
    """A shard's scan_core parts -> (payload [Seff, WP], live [Seff])
    (reference _build_payload; the dense table expanded from K2's and
    K4's reduce space as _scan_dense does, its keys decoded from the
    slot index as _dense_decode_keys does)."""
    K, A, hist_ais, nv_total, n_sum, WP = payload_spec(config)
    hist = hist_aggs(config)
    dev = part["dev"]
    if part["strategy"] == "dense":
        k2 = part["k2"]
        slots, Sr, compact = reduce_space(config)

        def expand(t, fill):
            if not compact:
                return t
            full = torch.full((slots, t.shape[1]), fill, dtype=t.dtype,
                              device=dev)
            full[:Sr - 1] = t[:Sr - 1]
            return full

        sums = expand(k2["sums"], 0)
        live_row = torch.arange(slots, device=dev) < slots - 1
        count = torch.where(live_row, sums[:, 0], 0)
        samples = torch.where(live_row, sums[:, 1], 0)
        keys = torch.from_numpy(dense_keys_np(
            config, part["raw"]["time_bucket"])).to(dev)
        mins, maxs = expand(k2["mins"], _BIG), expand(k2["maxs"], -_BIG)
        hcols = [expand(h, 0) for h in part["hists"]]
    else:
        k8 = part["k8"]
        S = config.table_slots
        sums = k8["sums"][:S]
        count, samples = sums[:, 0], sums[:, 1]
        keys, mins, maxs = k8["keys"], k8["mins"], k8["maxs"]
        hcols = []
    cols = [keys[:, k] for k in range(K)] + [count, samples]
    for ai in range(A):
        cols += [(sums[:, 2 + 3 * ai] > 0).to(torch.int64),
                 sums[:, 3 + 3 * ai], sums[:, 4 + 3 * ai]]
    for h in hcols:
        cols += [h[:, j] for j in range(h.shape[1])]
    S = count.shape[0]
    for src, fill in ((mins, _BIG), (maxs, -_BIG)):
        for ai in range(A):
            cols.append(src[:, hist.index(ai)] if ai in hist else
                        torch.full((S,), fill, dtype=torch.int64,
                                   device=dev))
    payload = torch.stack(cols, dim=1)
    return payload, (count > 0) | (samples > 0)


def _mul32(h, c: int):
    """(h * c) mod 2^32 for h < 2^32 without leaving int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def mix_keys_plain(keys):
    """The uint32 key hash of the reference's _mix_keys, in int64: FNV
    over each key's low and high 32-bit halves, then the finaliser."""
    h = torch.full((keys.shape[0],), 2166136261, dtype=torch.int64,
                   device=keys.device)
    for k in range(keys.shape[1]):
        v = keys[:, k]
        for part in (v & _M32, (v >> 32) & _M32):
            h = ((h ^ part) * 16777619) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def partition_rows_plain(payload, live, K: int, D: int, Sc: int):
    """-> (send [D, Sc, WP], overflow count): live rows by key owner, in
    row order within each owner (reference _partition_rows)."""
    S, WP = payload.shape
    dev = payload.device
    owner = torch.where(live, mix_keys_plain(payload[:, :K]) % D, D)
    order = torch.sort(owner, stable=True)[1]
    sowner = owner[order]
    counts = torch.bincount(sowner, minlength=D + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(S, device=dev) - starts[sowner]
    ok = (sowner < D) & (pos < Sc)
    slot = torch.where(ok, sowner * Sc + pos, D * Sc)
    send = torch.zeros((D * Sc + 1, WP), dtype=torch.int64, device=dev)
    send[slot] = payload[order]
    overflow = ((sowner < D) & (pos >= Sc)).sum()
    return send[:D * Sc].reshape(D, Sc, WP), overflow


def _stat_sources(config: ScanConfig, part: dict) -> list:
    """The [1] counts copied to a statistics row's words 3..: outlier
    counts, then (sorted) hist pair counts, one per histogram agg."""
    pairs = part.get("pairs") or [None] * len(part["nouts"])
    return list(part["nouts"]) + [p["npairs"] if p else None for p in pairs]


def shuffle_partition_plain(config: ScanConfig, part: dict, D: int, Sc: int,
                            send, stats) -> None:
    """Plain PyTorch version of K15: fills the shard's send buffer [D, Sc,
    WP] and its statistics row (all but word 0) in place."""
    K = config.n_key_cols
    payload, live = build_payload_plain(config, part)
    buf, overflow = partition_rows_plain(payload, live, K, D, Sc)
    send.copy_(buf)
    spill = part["k2"]["spill"] if part["strategy"] == "dense" \
        else part["spill"]
    stats[1] = spill.reshape(())
    stats[2] = overflow
    for i, n in enumerate(_stat_sources(config, part)):
        stats[3 + i] = 0 if n is None else n.reshape(())


class ShufflePartitionArgs(ctypes.Structure):
    """Mirror of struct ShufflePartitionArgs in csrc/shuffle_partition.cu."""
    _fields_ = [("desc", Desc)] + _ptr_fields(
        "tabs", "hist_nv", "agg_mm", "kb_min", "kb_card", "send", "status",
        "stats") + [("tb", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in (
            "Dl", "Seff", "D", "Sc", "K", "A", "L", "H", "WP", "dense",
            "compact", "Sr", "slots", "nkb", "tpos", "ntiles", "nstat")]


_PART_TILE = 1024              # rows per CTA (TILE in the source)


def shuffle_partition(config: ScanConfig, parts: list, D: int, Sc: int,
                      stats):
    """K15: every local shard's payload rows placed by key owner -> the
    send buffers [Dl, D, Sc, WP] int64 (zero where no row lands), and each
    shard's statistics row stats[d] [n_stats] int64 words 1.. (spill,
    overflow, outlier and hist pair counts), in place.  parts: the Dl
    shards' scan_core parts.  CUDA tensors launch the kernel once over
    every shard (csrc/shuffle_partition.cu: one memset and one launch);
    CPU tensors take the plain version shard by shard.

    Replaces sybil_tpu/parallel/mesh.py:_build_payload, _mix_keys and
    _partition_rows, and on the dense strategy sybil_tpu/ops/scan.py:
    _dense_decode_keys (608-626) and the reduce-space expansion of
    _scan_dense.  Bound by memory: the tables read once, the send buffers
    written once (see the source note).  A mesh batch makes one call, so
    the per-shard host work here is a few pointers and shape checks."""
    dev = stats.device
    Dl = len(parts)
    K, A, *_, WP = payload_spec(config)
    if dev.type == "cpu":
        send = torch.empty((Dl, D, Sc, WP), dtype=torch.int64)
        for d, part in enumerate(parts):
            shuffle_partition_plain(config, part, D, Sc, send[d], stats[d])
        return send
    if dev.type != "cuda":
        raise ValueError(f"shuffle_partition: unsupported device {dev}")
    if not 1 <= D <= MAX_SHARDS:
        raise ValueError(f"shuffle_partition: D {D} past {MAX_SHARDS}")
    hist = hist_aggs(config)
    H, L = len(hist), 2 + 3 * A
    _check_tensor(stats, (Dl, 3 + 2 * H), torch.int64, "stats", dev,
                  "shuffle_partition")
    a = ShufflePartitionArgs()
    slots = config.dense_slots
    dense = slots > 0
    if dense:
        _, rows, compact = reduce_space(config)
        Seff = slots
        nvs = [config.aggs[ai].num_values for ai in hist]
        a.dense, a.compact, a.Sr, a.slots = 1, int(compact), rows, slots
        a.nkb, a.tpos = len(config.key_bounds), config.time_key_pos
        a.tb = int(parts[0]["raw"]["time_bucket"])
    else:
        Seff = rows = config.max_groups
        nvs = []
    # the descriptor block: a record a shard (csrc/shuffle_partition.cu,
    # T_SUMS..: its tables' pointers, each checked against the shape the
    # kernel reads; min/max only when it reads them, and its statistics
    # sources), then the words every shard shares.  Built a record field
    # at a time over the shards.
    tabs = [part["k2" if dense else "k8"] for part in parts]

    def field(ts, shape, what):
        for d, t in enumerate(ts):
            _check_tensor(t, shape, torch.int64, f"shard {d}'s {what}", dev,
                          "shuffle_partition")
        return [t.data_ptr() for t in ts]

    zero = [0] * Dl
    fields = [field([t["sums"] for t in tabs],
                    (rows + (0 if dense else 1), L), "sums")]
    fields += [field([t[k] for t in tabs], (rows, H), k)
               for k in ("mins", "maxs")] if H else [zero, zero]
    fields.append(zero if dense else field([t["keys"] for t in tabs],
                                           (rows, K), "keys"))
    fields.append(field([t["spill"] for t in tabs] if dense else
                        [part["spill"] for part in parts], (1,), "spill"))
    if dense:
        fields += [field([part["hists"][h] for part in parts], (rows, nv),
                         "hist") for h, nv in enumerate(nvs)]
    else:
        fields += [zero] * H
    stat = [_stat_sources(config, part) for part in parts]
    fields += [[_ptr(st[i]) for st in stat] for i in range(2 * H)]
    _set_desc(a, dev, {
        "tabs": [w for rec in zip(*fields) for w in rec], "hist_nv": nvs,
        "agg_mm": [hist.index(ai) if ai in hist else -1 for ai in range(A)],
        "kb_min": [mn for mn, _ in config.key_bounds] if dense else [],
        "kb_card": [card for _, card in config.key_bounds] if dense else []})
    # one allocation, zeroed by the kernel's one memset: the send buffers,
    # and above one tile the look-back's ticket and status words
    ntiles = -(-Seff // _PART_TILE)
    nsend = Dl * D * Sc * WP
    buf = torch.empty(nsend + 1 + Dl * ntiles * D if ntiles > 1 else
                      (Dl, D, Sc, WP), dtype=torch.int64, device=dev)
    a.send, a.stats = buf.data_ptr(), stats.data_ptr()
    a.status = a.send + 8 * nsend if ntiles > 1 else 0
    a.Dl, a.Seff, a.D, a.Sc, a.K, a.A, a.L, a.H, a.WP = (Dl, Seff, D, Sc, K,
                                                          A, L, H, WP)
    a.ntiles, a.nstat = ntiles, 2 * H
    fn = kernels.entry("shuffle_partition", "shuffle_partition",
                       [ctypes.c_void_p, ctypes.c_void_p])
    kernels.check(fn(ctypes.byref(a), kernels.stream_handle(dev)),
                  "shuffle_partition")
    kernels.LAUNCHES["shuffle_partition"] += 1
    return buf if ntiles == 1 else buf[:nsend].view(Dl, D, Sc, WP)


# ---------------------------------------------------------------------------
# K16 shuffle_reduce: shuffle_keys, shuffle_reduce, shuffle_unpack
# ---------------------------------------------------------------------------

def _recv_live(rows, K: int):
    return (rows[:, K] > 0) | (rows[:, K + 1] > 0)


_KEYS_TILE = 8192              # rows a shuffle_keys CTA (KTILE in the source)
_MAX_PACK = 64                 # lanes a packed sort key holds (MAX_PACK)
_M64 = 2 ** 64 - 1


def _pack_plan(Dl: int, ranges: list):
    """How shuffle_keys packs the owners' sort key: the owner's lane and
    each key lane whose kept rows hold more than one value, the most
    significant first, lane k's code v - lo (SENTINEL: `dead`, the code
    past the live rows' greatest, or the greatest's own when that is
    INT64_MAX, so that a live INT64_MAX ties the dead rows as the
    reference's sort ties them) in just enough bits.  ranges: each key
    lane's (least, greatest) over the kept live rows, None when no row is
    live.  -> (wide: an int64 key, else int32; lanes, bits, lo, dead), or
    None when the codes take more than 63 bits (then one sort a lane)."""
    lanes, bits, lo, dead = [0], [(Dl - 1).bit_length()], [0], [0]
    for k, rg in enumerate(ranges):
        if rg is None:
            continue                   # every kept row SENTINEL: one code
        mn, mx = rg
        dk = mx - mn if mx == SENTINEL else mx - mn + 1
        if dk.bit_length():
            lanes.append(k + 1)
            bits.append(dk.bit_length())
            lo.append(mn)
            dead.append(dk)
    if sum(bits) > 63:
        return None
    return sum(bits) > 31, lanes, bits, lo, dead


def _pack_plain(lanes, plan):
    """The packed sort key of shuffle_keys' lanes [K + 1, M] by plan."""
    wide, idx, bits, lo, dead = plan
    code = torch.zeros(lanes.shape[1], dtype=torch.int64,
                       device=lanes.device)
    for k, b, mn, dk in zip(idx, bits, lo, dead):
        v = lanes[k]
        code = (code << b) | torch.where(v == SENTINEL, dk, v - mn)
    return code if wide else code.to(torch.int32)


def shuffle_keys_plain(config: ScanConfig, recv):
    """Plain PyTorch version of shuffle_keys -> (front, src int32 [M], off
    int32 [Dl + 1])."""
    K = config.n_key_cols
    Dl, N, WP = recv.shape
    dev = recv.device
    flat = recv.reshape(Dl * N, WP)
    live = _recv_live(flat, K)
    # each tile's first dead row: the tiles of _KEYS_TILE rows an owner
    i = torch.arange(Dl * N, device=dev)
    tile = (i // N) * -(-N // _KEYS_TILE) + (i % N) // _KEYS_TILE
    ntl = Dl * -(-N // _KEYS_TILE)
    first = torch.full((ntl,), Dl * N, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, tile[~live], i[~live], "amin")
    src = torch.nonzero(live | (i == first[tile])).reshape(-1)
    owner = src // N
    klive = live[src]
    keys = torch.cat([owner[None, :], torch.where(
        klive[None, :], flat[src, :K].t(), SENTINEL)])
    off = torch.zeros(Dl + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(torch.bincount(owner, minlength=Dl), 0)
    ranges = [None] * K
    if klive.any():
        lv = flat[src[klive], :K]
        ranges = list(zip(lv.min(dim=0)[0].tolist(),
                          lv.max(dim=0)[0].tolist()))
    plan = _pack_plan(Dl, ranges)
    front = ({"key": _pack_plain(keys, plan), "keys": None} if plan else
             {"key": None, "keys": keys})
    return front, src.to(torch.int32), off.to(torch.int32)


class ShuffleKeysArgs(ctypes.Structure):
    """Mirror of struct ShuffleKeysArgs in csrc/shuffle_reduce.cu."""
    _fields_ = _ptr_fields("rows", "keys", "src", "off", "status",
                           "info") + [("N", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("Dl", "K", "WP", "ntiles")]


class ShufflePackArgs(ctypes.Structure):
    """Mirror of struct ShufflePackArgs in csrc/shuffle_reduce.cu."""
    _fields_ = _ptr_fields("keys", "out") + [
        ("stride", ctypes.c_longlong), ("M", ctypes.c_longlong),
        ("n", ctypes.c_int), ("wide", ctypes.c_int),
        ("lane", ctypes.c_int * _MAX_PACK), ("bits", ctypes.c_int * _MAX_PACK),
        ("lo", ctypes.c_longlong * _MAX_PACK),
        ("dead", ctypes.c_longlong * _MAX_PACK)]


def shuffle_keys(config: ScanConfig, recv):
    """K16, shuffle_keys entry: every local owner's received rows [Dl, N,
    WP] compacted to the owner's live rows and the first dead row of each
    _KEYS_TILE-row tile (which keeps the reference's segment of dead and
    all-SENTINEL rows: see the source note), in row order, owner after
    owner -> (front, src, off).  front: the operands of the owners' sort
    by (owner, key 0, ...) (reference _segment_reduce 156-157, dead rows
    keyed SENTINEL), as sort_rows takes them: "key", the packed key
    (_pack_plan: int32 or int64 [M]) when the owner and the keys' codes
    fit 63 bits, else None and "keys" [K + 1, M] int64 (row 0 the owner,
    row 1 + k key k).  src int32 [M]: each kept row's index in recv viewed
    as [Dl * N, WP]; off int32 [Dl + 1]: each owner's first kept
    position, M last.  CUDA tensors launch the kernels
    (csrc/shuffle_reduce.cu: one memset and one launch over every owner,
    then, packed, one more) with one device-to-host read between (M and
    the key ranges); CPU tensors take the plain version.  Bound by
    memory."""
    dev = recv.device
    if dev.type == "cpu":
        return shuffle_keys_plain(config, recv)
    if dev.type != "cuda":
        raise ValueError(f"shuffle_keys: unsupported device {dev}")
    K = config.n_key_cols
    Dl, N, WP = recv.shape
    _check_tensor(recv, (Dl, N, WP), torch.int64, "recv", dev, "shuffle_keys")
    ntiles = -(-N // _KEYS_TILE)
    cap = Dl * N
    # one allocation: the lanes [K + 1, cap], the look-back's ticket and
    # status words and the info words (the memset's), then src and off as
    # int32
    w_st = (K + 1) * cap
    w_info = w_st + 1 + Dl * ntiles
    w_int = w_info + 1 + 2 * K
    buf = torch.empty(w_int + (cap + Dl + 2) // 2, dtype=torch.int64,
                      device=dev)
    base = buf.data_ptr()
    a = ShuffleKeysArgs(recv.data_ptr(), base, base + 8 * w_int,
                        base + 8 * w_int + 4 * cap, base + 8 * w_st,
                        base + 8 * w_info, N, Dl, K, WP, ntiles)
    fn = kernels.entry("shuffle_reduce", "shuffle_keys",
                       [ctypes.c_void_p, ctypes.c_void_p])
    kernels.check(fn(ctypes.byref(a), kernels.stream_handle(dev)),
                  "shuffle_keys")
    kernels.LAUNCHES["shuffle_keys"] += 1
    M, *mm = buf[w_info:w_int].tolist()
    ints = buf[w_int:].view(torch.int32)
    src, off = ints[:M], ints[cap:cap + Dl + 1]
    ranges = [None] * K
    if mm[0] or mm[1]:         # a live row: each lane's greatest u and ~u
        ranges = [((~mm[2 * k + 1] & _M64) - 2 ** 63,
                   (mm[2 * k] & _M64) - 2 ** 63) for k in range(K)]
    plan = _pack_plan(Dl, ranges)
    if plan is None:
        return ({"key": None, "keys": buf[:w_st].view(K + 1, cap)[:, :M]},
                src, off)
    wide, idx, bits, lo, dead = plan
    packed = torch.empty(M, dtype=torch.int64 if wide else torch.int32,
                         device=dev)
    n = len(idx)
    p = ShufflePackArgs(base, packed.data_ptr(), cap, M, n, int(wide))
    p.lane[:n], p.bits[:n], p.lo[:n], p.dead[:n] = idx, bits, lo, dead
    fn = kernels.entry("shuffle_reduce", "shuffle_pack",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    kernels.check(fn(ctypes.byref(p), _grid(dev, M, 0, False),
                     kernels.stream_handle(dev)), "shuffle_keys")
    return {"key": packed, "keys": None}, src, off


def shuffle_reduce_plain(config: ScanConfig, recv, src, order, off, merged,
                         flive, stats) -> None:
    """Plain PyTorch version of K16 (reference _segment_reduce, owner by
    owner over shuffle_keys' kept rows): fills merged [Dl, cap, WP], flive
    int32 [Dl, cap] and stats[:, 0] in place."""
    K, A, _, _, n_sum, WP = payload_spec(config)
    Dl, cap = flive.shape
    dev = recv.device
    rows = recv.reshape(-1, WP)[src.to(torch.int64)[sorted_perm(order)]]
    bounds = off.tolist()
    for d in range(Dl):
        srows = rows[bounds[d]:bounds[d + 1]]
        slive = _recv_live(srows, K)
        skeys = torch.where(slive[:, None], srows[:, :K], SENTINEL)
        differs = torch.ones(srows.shape[0], dtype=torch.bool, device=dev)
        differs[1:] = (skeys[1:] != skeys[:-1]).any(dim=1)
        gid = torch.cumsum(differs.to(torch.int64), 0) - 1
        contrib = slive & (gid < cap)
        cgid = torch.where(contrib, gid, cap)
        ng = (differs & slive).sum()
        sums = torch.zeros((cap + 1, n_sum), dtype=torch.int64, device=dev)
        sums.index_add_(0, cgid, torch.where(contrib[:, None],
                                             srows[:, K:K + n_sum], 0))
        out = [None, sums[:cap], None, None]
        for i, (lo, init, fill, how) in enumerate(
                ((K + n_sum, _I64_MAX, _BIG, "amin"),
                 (K + n_sum + A, _I64_MIN, -_BIG, "amax"))):
            acc = torch.full((cap + 1, A), init, dtype=torch.int64,
                             device=dev)
            acc.scatter_reduce_(0, cgid[:, None].expand(-1, A),
                                torch.where(contrib[:, None],
                                            srows[:, lo:lo + A], fill), how)
            out[2 + i] = acc[:cap]
        kt = torch.zeros((cap + 1, K), dtype=torch.int64, device=dev)
        kt[torch.where(differs & contrib, cgid, cap)] = skeys
        out[0] = kt[:cap]
        merged[d].copy_(torch.cat(out, dim=1))
        flive[d].copy_((torch.arange(cap, device=dev)
                        < torch.clamp(ng, max=cap)).to(torch.int32))
        stats[d, 0] = ng


class ShuffleReduceArgs(ctypes.Structure):
    """Mirror of struct ShuffleReduceArgs in csrc/shuffle_reduce.cu."""
    _fields_ = _ptr_fields("rows", "src", "p", "base", "off", "merged",
                           "flive", "stats", "scratch") + [
        ("M", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("cap", "K", "n_sum", "A", "WP", "Dl",
                                    "nstat")]


_RED_THREADS = 256             # rows a CTA numbers at a time (THREADS)


def shuffle_reduce(config: ScanConfig, recv, src, order, off, merged, flive,
                   stats) -> None:
    """K16: merges every local owner's kept rows (shuffle_keys' src and
    off over recv [Dl, N, WP]) in the sorted order `order` (sort_rows
    over shuffle_keys' operands: owner d's rows at positions [off[d],
    off[d + 1])) into merged [Dl, cap, WP] int64 and flive int32 [Dl, cap]
    (owner d's first min(n_groups, cap) rows live), and writes each
    owner's n_groups (live segments) as stats[d, 0] of the int64 [Dl,
    n_stats] statistics rows, in place.  CUDA tensors launch the kernel
    (csrc/shuffle_reduce.cu); CPU tensors take the plain version.

    Replaces sybil_tpu/parallel/mesh.py:_segment_reduce after its sort,
    for every owner: the segment boundaries and ids, the segment sums,
    mins and maxs, the key readout of each segment's first row.  Bound by
    memory (the kept rows gathered once in sorted order); two launches of
    G CTAs an owner, at most two CTAs an SM in all (see the source
    note)."""
    dev = recv.device
    if dev.type == "cpu":
        shuffle_reduce_plain(config, recv, src, order, off, merged, flive,
                             stats)
        return
    if dev.type != "cuda":
        raise ValueError(f"shuffle_reduce: unsupported device {dev}")
    K, A, _, _, n_sum, WP = payload_spec(config)
    Dl, N, _ = recv.shape
    M = src.shape[0]
    cap = merged.shape[1]
    ns = stats.shape[1]
    for t, shape, dtype, what in (
            (recv, (Dl, N, WP), torch.int64, "recv"),
            (src, (M,), torch.int32, "src"),
            (order["p"], (M,), torch.int64, "p"),
            (off, (Dl + 1,), torch.int32, "off"),
            (merged, (Dl, cap, WP), torch.int64, "merged"),
            (flive, (Dl, cap), torch.int32, "flive"),
            (stats, (Dl, ns), torch.int64, "stats")):
        _check_tensor(t, shape, dtype, what, dev, "shuffle_reduce")
    if order["base"] is not None:
        _check_tensor(order["base"], (M,), torch.int64, "base", dev,
                      "shuffle_reduce")
    # G CTAs an owner: about an owner's share of the walk a CTA, at most
    # two CTAs an SM over all the owners
    G = max(1, min(-(-M // (Dl * _RED_THREADS)), 2 * _sm_count(dev) // Dl))
    scratch = torch.empty(2 * M + 2 * Dl * G, dtype=torch.int32, device=dev)
    a = ShuffleReduceArgs(
        recv.data_ptr(), src.data_ptr(), order["p"].data_ptr(),
        _ptr(order["base"]), off.data_ptr(), merged.data_ptr(),
        flive.data_ptr(), stats.data_ptr(), scratch.data_ptr(), M, cap, K,
        n_sum, A, WP, Dl, ns)
    fn = kernels.entry("shuffle_reduce", "shuffle_reduce",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    kernels.check(fn(ctypes.byref(a), G, kernels.stream_handle(dev)),
                  "shuffle_reduce")
    kernels.LAUNCHES["shuffle_reduce"] += 1


def merge_owners(config: ScanConfig, recv, merged, flive, stats) -> None:
    """The owners' merge of a mesh batch (reference _segment_reduce, every
    local owner): shuffle_keys over recv [Dl, N, WP], the stable sort of
    sort_rows by (owner, keys) (one of the packed key, or K + 1 of the
    lanes), shuffle_reduce into merged [Dl, cap, WP], flive [Dl, cap] and
    stats[:, 0]."""
    front, src, off = shuffle_keys(config, recv)
    shuffle_reduce(config, recv, src, sort_rows(config, front), off, merged,
                   flive, stats)


def shuffle_unpack_plain(config: ScanConfig, flat, flive, top, stats,
                         S: int) -> dict:
    """Plain PyTorch version of shuffle_unpack (reference _sharded_scan
    291-305 and _unpack_payload)."""
    K, A, hist_ais, nv_total, n_sum, WP = payload_spec(config)
    L = 2 + 3 * A
    dev = flat.device
    src = top.to(torch.int64)
    k = src.numel()
    table = torch.zeros((S, WP), dtype=torch.int64, device=dev)
    table[:k] = flat[src]
    tlive = torch.zeros((S, 1), dtype=torch.bool, device=dev)
    tlive[:k, 0] = flive[src] != 0
    sums = torch.zeros((S + 1, L), dtype=torch.int64, device=dev)
    sums[:S] = torch.where(tlive, table[:, K:K + L], 0)
    hists, off = [], K + L
    for ai in hist_ais:
        nv = config.aggs[ai].num_values
        hists.append(torch.where(tlive, table[:, off:off + nv], 0))
        off += nv
    meta = stats.sum(dim=0)
    meta[2] += torch.clamp(meta[0] - S, min=0)
    return {"keys": table[:, :K].contiguous(), "sums": sums,
            "mins": table[:, K + n_sum:K + n_sum + A].contiguous(),
            "maxs": table[:, K + n_sum + A:].contiguous(), "hists": hists,
            "meta": meta}


class ShuffleUnpackArgs(ctypes.Structure):
    """Mirror of struct ShuffleUnpackArgs in csrc/shuffle_reduce.cu."""
    _fields_ = [("desc", Desc)] + _ptr_fields(
        "flat", "flive", "top", "stats", "keys", "sums", "mins", "maxs",
        "hist", "hist_nv", "meta") + [
        ("k", ctypes.c_int),
        ("S", ctypes.c_int),
        ("K", ctypes.c_int),
        ("L", ctypes.c_int),
        ("n_sum", ctypes.c_int),
        ("A", ctypes.c_int),
        ("H", ctypes.c_int),
        ("WP", ctypes.c_int),
        ("D", ctypes.c_int),
        ("ncols", ctypes.c_int),
    ]


def shuffle_unpack(config: ScanConfig, flat, flive, top, stats,
                   S: int) -> dict:
    """K16, shuffle_unpack entry: the gathered merged tables flat [Dn, WP]
    with their live flags flive int32 [Dn], K12's order top int32 [k] and
    the shards' statistics rows stats [D, n_stats] -> the final table S
    rows long, split as K3's keyed form and K10 read it: {"keys" [S, K],
    "sums" [S+1, L] (count, samples, and per aggregation exists, count,
    wv; zero on a dead row and on row S), "mins"/"maxs" [S, A], "hists"
    [S, nv] per histogram aggregation (dense), "meta" [n_stats]: the
    statistics summed over the shards, max(n_groups - S, 0) added to the
    overflow}.  CUDA tensors launch the kernel (csrc/shuffle_reduce.cu);
    CPU tensors take the plain version.

    Replaces the compaction table[top] of sybil_tpu/parallel/mesh.py:
    _sharded_scan (291-295), its psums (296-305) and _unpack_payload.
    Bound by memory: k rows of WP words read, S rows written, a thread
    an output word."""
    dev = flat.device
    if dev.type == "cpu":
        return shuffle_unpack_plain(config, flat, flive, top, stats, S)
    if dev.type != "cuda":
        raise ValueError(f"shuffle_unpack: unsupported device {dev}")
    K, A, hist_ais, nv_total, n_sum, WP = payload_spec(config)
    L = 2 + 3 * A
    Dn = flat.shape[0]
    D, ncols = stats.shape
    k = top.numel()
    _check_tensor(flat, (Dn, WP), torch.int64, "flat", dev, "shuffle_unpack")
    _check_tensor(flive, (Dn,), torch.int32, "flive", dev, "shuffle_unpack")
    _check_tensor(top, (k,), torch.int32, "top", dev, "shuffle_unpack")
    _check_tensor(stats, (D, n_stats(config)), torch.int64, "stats", dev,
                  "shuffle_unpack")
    nvs = [config.aggs[ai].num_values for ai in hist_ais]
    # the outputs are views of one allocation
    shapes = [(S, K), (S + 1, L), (S, A), (S, A)] + [(S, nv) for nv in nvs] \
        + [(ncols,)]
    sizes = [math.prod(x) for x in shapes]
    parts = torch.empty(sum(sizes), dtype=torch.int64,
                        device=dev).split_with_sizes(sizes)
    keys, sums, mins, maxs, *hists, meta = (t.view(x) for t, x in
                                            zip(parts, shapes))
    out = {"keys": keys, "sums": sums, "mins": mins, "maxs": maxs,
           "hists": hists, "meta": meta}
    a = ShuffleUnpackArgs()
    if hists:       # no histogram: the kernel reads no descriptor word
        _set_desc(a, dev, {"hist": [h.data_ptr() for h in hists],
                           "hist_nv": nvs})
    a.flat, a.flive, a.top, a.stats = (flat.data_ptr(), flive.data_ptr(),
                                       top.data_ptr(), stats.data_ptr())
    a.keys, a.sums = keys.data_ptr(), sums.data_ptr()
    a.mins, a.maxs = mins.data_ptr(), maxs.data_ptr()
    a.meta = meta.data_ptr()
    a.k, a.S, a.K, a.L, a.n_sum, a.A = k, S, K, L, n_sum, A
    a.H, a.WP, a.D, a.ncols = len(hist_ais), WP, D, ncols
    words = S * (K + L + nv_total + 2 * A) + L
    fn = kernels.entry("shuffle_reduce", "shuffle_unpack",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    kernels.check(fn(ctypes.byref(a), _grid(dev, words, 0, False),
                     kernels.stream_handle(dev)), "shuffle_unpack")
    kernels.LAUNCHES["shuffle_unpack"] += 1
    return out


# ---------------------------------------------------------------------------
# the sharded scan
# ---------------------------------------------------------------------------

def _row_names(config: ScanConfig, raw: dict) -> list[str]:
    """The row-level side outputs that stay per shard (reference
    _row_names): outlier masks and values, the sorted strategy's sparse
    hist pairs and key rows, the distinct pairs, the matched mask."""
    names = [k for k in raw if k.startswith("agg") and (
        "_out_" in k or "_hp_" in k)]
    if config.strategy != "dense" and (config.distinct_cols or (
            config.track_outliers and hist_aggs(config))):
        names.append("kmat")     # the distinct pairs' and outlier rows' keys
    if config.strategy != "dense" and config.distinct_cols:
        names += ["dmat", "pair_mask"]
    if "matched" in raw:
        names.append("matched")
    return names


def _merged_parts(config: ScanConfig, un: dict, rows: dict, R: int, dev,
                  time_bucket: int, cols) -> dict:
    """The merged table and the joined row outputs as pack_parts takes
    them (the reference's merged out dict, mesh.py:298-330)."""
    hist = hist_aggs(config)
    H = len(hist)
    meta = un["meta"]
    nouts = [meta[3 + i:4 + i] for i in range(H)]
    raw = dict(rows, cols=cols, time_bucket=time_bucket)
    parts = {"R": R, "dev": dev, "nouts": nouts, "raw": raw,
             "meta": meta}
    table = {"keys": un["keys"], "sums": un["sums"], "mins": un["mins"],
             "maxs": un["maxs"], "num_groups": meta[0:1]}
    if config.strategy == "dense":
        for ai, h in zip(hist, un["hists"]):
            raw[f"agg{ai}_hist"] = h
        parts.update(strategy="dense", hists=un["hists"], hll=None,
                     k2=dict(table, spill=meta[1:2], overflow=meta[2:3]))
        return parts
    table.update(pair_mask=rows.get("pair_mask"), kmat=rows.get("kmat"),
                 dmat=rows.get("dmat"))
    pairs = [{key: rows[f"agg{ai}_{key}"]
              for key in ("hp_mask", "hp_bv", "hp_w", "hp_keys")}
             | {"npairs": meta[3 + H + i:4 + H + i]}
             for i, ai in enumerate(hist)]
    parts.update(strategy="sorted", k8=table, spill=meta[1:2],
                 overflow=meta[2:3], pairs=pairs)
    return parts


def sharded_scan(config: ScanConfig, mesh: Mesh, cols, nrec,
                 filter_vals=None, bitsets=(), time_bucket: int = 1,
                 set_aux=None) -> dict:
    """The data-parallel scan and the hash-partitioned shuffle over the
    mesh (reference sharded_scan / _sharded_scan) -> the merged parts
    pack_parts packs, with "raw" (the escalation fetches' and the samples
    walk's tensors, joined over every shard) and "meta" (the summed
    statistics: n_groups, spill, overflow, outlier and hist pair counts).

    cols {name: (values, valid) [B, C]}, nrec int32 [B]: this process's
    Dl shards' blocks, B divisible by Dl; set_aux {set column: (prow
    int32 [Dl, M], pval int64 [Dl, M], n real entries per shard)}, each
    shard's CSR with shard-local row ids (pads at R_local); the other
    arguments as scan_packed's.  Dense and sorted strategies only: the
    enumerated strategy is off under a mesh (enum_radix)."""
    D, Dl = mesh.D, mesh.Dl
    dev = nrec.device
    B, C = _batch_shape(cols)
    if B % Dl:
        raise ValueError(f"sharded_scan: {B} blocks do not split into "
                         f"{Dl} shards")
    Bs = B // Dl
    S, Sc = shuffle_caps(config, D)
    K, A, hist_ais, nv_total, n_sum, WP = payload_spec(config)
    time_bucket = int(time_bucket)
    set_aux = set_aux or {}
    stats = torch.zeros((Dl, n_stats(config)), dtype=torch.int64,
                        device=dev)
    parts = []
    for d in range(Dl):
        blk = slice(d * Bs, (d + 1) * Bs)
        parts.append(scan_core(
            config, {k: (v[blk], m[blk]) for k, (v, m) in cols.items()},
            nrec[blk], filter_vals, bitsets, time_bucket,
            {k: (pr[d], pv[d], ns[d]) for k, (pr, pv, ns) in
             set_aux.items()}))
    send = shuffle_partition(config, parts, D, Sc, stats)
    raws = [part["raw"] for part in parts]
    del parts
    recv = mesh.all_to_all(send)
    merged = torch.empty((Dl, Sc, WP), dtype=torch.int64, device=dev)
    flive = torch.empty((Dl, Sc), dtype=torch.int32, device=dev)
    merge_owners(config, recv, merged, flive, stats)
    flat = mesh.all_gather(merged).reshape(D * Sc, WP)
    flive = mesh.all_gather(flive).reshape(D * Sc)
    stats = mesh.all_gather(stats)
    top = topk_rows(flive, min(S, D * Sc), two_valued=True)
    un = shuffle_unpack(config, flat, flive, top, stats, S)
    R = mesh.nproc * B * C
    rows = {}
    if mesh.group is not None and config.strategy == "dense" and \
            config.track_outliers and hist_ais:
        rows = _gather_outlier_rows(config, mesh, raws, cols, time_bucket, R)
    rows.update({k: mesh.all_gather(torch.cat([r[k] for r in raws]))
                 for k in _row_names(config, raws[0]) if k not in rows})
    return _merged_parts(config, un, rows, R, dev, time_bucket,
                         cols if mesh.group is None else None)


def _gather_outlier_rows(config: ScanConfig, mesh: Mesh, raws: list, cols,
                         time_bucket: int, R: int) -> dict:
    """A multi-process dense scan's outlier rows, which K5 and
    fetch_outliers read with their keys from the columns that only their
    own process holds.  Each process keeps the rows of its span that any
    tracked aggregation marks, and the last process also the batch's
    last row (K5's pad row), with their keys (key_rows); the gather joins
    the spans in process order, each padded in front with unmarked rows
    to one length, at least K5's section over the processes.  -> the
    masks, values and keys ("kmat") as row outputs: marked rows in the
    batch's order and the last row last, so K5 packs the reference's
    words, with O(outliers) rows crossing processes, not O(R)."""
    dev = cols[next(iter(cols))][0].device
    hist = hist_aggs(config)
    masks = [torch.cat([r[f"agg{ai}_out_mask"] for r in raws]) for ai in hist]
    vals = [torch.cat([r[f"agg{ai}_out_val"] for r in raws]) for ai in hist]
    keep = torch.stack(masks).any(dim=0)
    if mesh.pid == mesh.nproc - 1:
        keep[-1] = True
    idx = torch.nonzero(keep).reshape(-1)
    n = mesh.all_gather(torch.tensor([idx.numel()], device=dev))
    span = max(int(n.max().item()), -(-min(config.max_out, R) // mesh.nproc))
    pad = span - idx.numel()

    def gather(x):
        out = torch.zeros((span,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[pad:] = x
        return mesh.all_gather(out)

    rows = {"kmat": gather(key_rows(config, cols, idx, time_bucket))}
    for ai, m, v in zip(hist, masks, vals):
        rows[f"agg{ai}_out_mask"] = gather(m[idx])
        rows[f"agg{ai}_out_val"] = gather(v[idx])
    return rows
