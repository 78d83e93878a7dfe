"""Host-side histogram objects.

Exact ports of the reference histogram math so query output matches
byte-for-byte; the *per-row* bucket binning runs on device (ops/scan.py)
and these objects are reconstituted from the device's per-group bucket
count arrays.

- BasicHist: fixed linear buckets over the table-level [Min, Max]
  (src/lib/hist_basic.go).  Includes the reference's quirks: NumBuckets
  gets +1 then Values gets another +1 slot; outliers fold their weight
  into the last bucket *and* keep their raw values for stddev/sparse
  buckets; percentile CDF walk iterates every bucket index including
  empty ones.
- MultiHist (-loghist): ladder of sub-BasicHists with ranges halving from
  the top (src/lib/hist_multi.go:223-257); percentiles/stddev computed
  over the sparse union of sub-buckets.
"""

from __future__ import annotations

import math

import numpy as np

from ..constants import HIST_OUTLIER_FACTOR, NUM_BUCKETS


def basic_bucket_layout(info_min: int, info_max: int, hist_bucket: int = 0,
                        buckets: int = NUM_BUCKETS):
    """-> (bucket_size, num_values) replicating SetupBuckets
    (hist_basic.go:34-70).  num_values = len(h.Values)."""
    size = info_max - info_min
    bucket_size = size // buckets
    if hist_bucket > 0:
        bucket_size = hist_bucket
    num_buckets = buckets
    if bucket_size == 0:
        if size < 100:
            bucket_size = 1
            num_buckets = size
        else:
            bucket_size = size // 100
            num_buckets = size // bucket_size
    num_buckets += 1
    return bucket_size, num_buckets + 1


_EMPTY_I64 = np.zeros(0, dtype=np.int64)   # shared; never mutated in place


class BasicHist:
    __slots__ = ("info_min", "info_max", "hist_bucket", "percentile_mode",
                 "min", "max", "count", "samples", "avg", "bucket_size",
                 "num_values", "values", "outliers", "underliers")

    @classmethod
    def from_sums(cls, info_min: int, info_max: int, count: int, wv,
                  vmin: int, vmax: int) -> "BasicHist":
        """Minimal avg-op construction from device sums (no bucket
        arrays, no layout math) — the finish path creates one hist per
        group row, and for plain-avg rollups this is the hot loop."""
        h = object.__new__(cls)
        h.info_min = info_min
        h.info_max = info_max
        h.hist_bucket = 0
        h.percentile_mode = False
        h.min = vmin if vmin < info_min else info_min
        h.max = vmax if vmax > info_max else info_max
        h.count = count
        h.samples = 0
        h.avg = wv / count if count else 0.0
        h.bucket_size = 0
        h.num_values = 0
        h.values = _EMPTY_I64
        h.outliers = []
        h.underliers = []
        return h

    def __init__(self, info_min: int, info_max: int, hist_bucket: int = 0,
                 percentile_mode: bool = True):
        self.info_min = int(info_min)
        self.info_max = int(info_max)
        self.hist_bucket = hist_bucket
        self.percentile_mode = percentile_mode
        self.min = int(info_min)   # bucket base; never decreases (discard rule)
        self.max = int(info_max)
        self.count = 0
        self.samples = 0
        self.avg = 0.0
        if percentile_mode:
            self.bucket_size, self.num_values = basic_bucket_layout(
                info_min, info_max, hist_bucket)
            self.values = np.zeros(self.num_values, dtype=np.int64)
        else:
            self.bucket_size, self.num_values = 0, 0
            self.values = np.zeros(0, dtype=np.int64)
        self.outliers: list[int] = []
        self.underliers: list[int] = []

    # --- construction from device partials ---
    def load_device_partial(self, count, wv_sum, bucket_counts=None,
                            outlier_values=(), vmin=None, vmax=None,
                            samples=0):
        """Install sums computed on device: count=Σw, wv_sum=Σw·v over
        non-discarded rows; bucket_counts already has outlier weight folded
        into the last slot (the device clamps, mirroring hist_basic.go:134)."""
        count = int(count)
        if count:
            new_avg = (self.avg * self.count + float(wv_sum)) / (self.count + count)
            self.avg = new_avg
        self.count += count
        self.samples += int(samples)
        if bucket_counts is not None and self.percentile_mode:
            self.values += np.asarray(bucket_counts, dtype=np.int64)
        self.outliers.extend(int(v) for v in outlier_values)
        if vmin is not None and count:
            self.min = min(self.min, int(vmin))
        if vmax is not None and count:
            self.max = max(self.max, int(vmax))

    def clone(self) -> "BasicHist":
        h = BasicHist(self.info_min, self.info_max, self.hist_bucket,
                      self.percentile_mode)
        h.combine(self)
        return h

    def combine(self, other: "BasicHist") -> None:
        """Port of BasicHist.Combine (hist_basic.go:259-279)."""
        if self.percentile_mode and other.percentile_mode and len(other.values):
            if len(self.values) == len(other.values):
                self.values += other.values
        total = self.count + other.count
        if total:
            self.avg = (self.avg * (self.count / total)
                        + other.avg * (other.count / total))
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.samples += other.samples
        self.count = total
        self.outliers.extend(other.outliers)
        self.underliers.extend(other.underliers)

    # --- row-at-a-time path (oracle tests + row-store scan) ---
    def add_weighted_value(self, value: int, weight: int,
                           weight_mode: bool = False) -> None:
        """Exact port of AddWeightedValue (hist_basic.go:101-151)."""
        if value > self.info_max * HIST_OUTLIER_FACTOR or value < self.info_min:
            return
        if weight_mode or weight > 1:
            self.samples += 1
            self.count += weight
        else:
            self.count += 1
        self.avg = self.avg + ((float(value) - self.avg) / self.count) * weight
        self.max = max(self.max, value)
        self.min = min(self.min, value)
        if not self.percentile_mode:
            return
        bucket = (value - self.min) // self.bucket_size
        if bucket >= len(self.values):
            self.outliers.append(value)
            bucket = len(self.values) - 1
        if bucket < 0:
            self.underliers.append(value)
            bucket = 0
        self.values[bucket] += weight

    # --- reference accessors ---
    def mean(self) -> float:
        return self.avg

    def total_count(self) -> int:
        return self.count

    def sum(self) -> float:
        return self.avg * float(self.count)

    def get_percentiles(self) -> list[int]:
        """Port of GetPercentiles (hist_basic.go:153-183), including the
        walk over empty buckets and the final-slot bucket-index write that
        the [:100] truncation hides."""
        if self.count == 0:
            return []
        percentiles = [0] * 101
        percentiles[0] = self.min
        count = 0
        prev_p = 0
        for k in range(len(self.values)):
            key_count = int(self.values[k])
            count += key_count
            p = (100 * count) // self.count
            val = k * self.bucket_size + self.min
            for ip in range(prev_p, min(p, 100) + 1):
                percentiles[ip] = val
            if p <= 100:
                percentiles[p] = k
            prev_p = p
        return percentiles[:100]

    def get_stddev(self) -> float:
        """Port of GetStdDev (hist_basic.go:192-219): bucket midpoints are
        bucket*size+min; outliers/underliers contribute their raw values."""
        if self.count == 0:
            return 0.0
        sum_variance = 0.0
        for k in range(len(self.values)):
            cnt = int(self.values[k])
            val = k * self.bucket_size + self.min
            delta = float(val) - self.avg
            sum_variance += delta * delta * (cnt / self.count)
        for v in self.outliers:
            sum_variance += ((float(v) - self.avg) ** 2) / self.count
        for v in self.underliers:
            sum_variance += ((float(v) - self.avg) ** 2) / self.count
        return math.sqrt(sum_variance)

    def get_sparse_buckets(self) -> dict[int, int]:
        """GetSparseBuckets (hist_basic.go:221-239): nonzero buckets at
        value k*size+min, plus each outlier/underlier value counted +1."""
        ret: dict[int, int] = {}
        for k in range(len(self.values)):
            v = int(self.values[k])
            if v > 0:
                ret[k * self.bucket_size + self.min] = v
        for v in self.outliers:
            ret[v] = ret.get(v, 0) + 1
        for v in self.underliers:
            ret[v] = ret.get(v, 0) + 1
        return ret

    def get_str_buckets(self) -> dict[str, int]:
        """GetStrBuckets (hist_basic.go:241-257): ALL buckets (also zero),
        then outliers/underliers +1."""
        ret: dict[str, int] = {}
        for k in range(len(self.values)):
            ret[str(k * self.bucket_size + self.min)] = int(self.values[k])
        for v in self.outliers:
            ret[str(v)] = ret.get(str(v), 0) + 1
        for v in self.underliers:
            ret[str(v)] = ret.get(str(v), 0) + 1
        return ret

    def range_(self):
        return self.min, self.max


def multi_hist_layout(info_min: int, info_max: int, hist_bucket: int = 0):
    """Port of MultiHist.TrackPercentiles (hist_multi.go:223-257):
    -> list of (sub_min, sub_max, bucket_size, num_values, flat_offset),
    ordered top range first, exactly like Subhists."""
    bucket_size = info_max - info_min
    num_hists = 0
    t = bucket_size
    while t > NUM_BUCKETS:
        t >>= 1
        num_hists += 1
    subs = []
    right_edge = info_max
    offset = 0
    for _ in range(num_hists):
        bucket_size >>= 1
        sub_min = right_edge - bucket_size
        sub_max = right_edge
        bs, nv = basic_bucket_layout(sub_min, sub_max, hist_bucket)
        subs.append((sub_min, sub_max, bs, nv, offset))
        offset += nv
        right_edge = sub_min
    bs, nv = basic_bucket_layout(info_min, right_edge, hist_bucket)
    subs.append((info_min, right_edge, bs, nv, offset))
    return subs


class MultiHist:
    def __init__(self, info_min: int, info_max: int, hist_bucket: int = 0,
                 percentile_mode: bool = True):
        self.info_min = int(info_min)
        self.info_max = int(info_max)
        self.hist_bucket = hist_bucket
        self.percentile_mode = percentile_mode
        self.min = int(info_min)
        self.max = int(info_max)
        self.count = 0
        self.samples = 0
        self.avg = 0.0
        self.subs = (multi_hist_layout(info_min, info_max, hist_bucket)
                     if percentile_mode else [])
        self.total_values = sum(s[3] for s in self.subs)
        self.values = np.zeros(self.total_values, dtype=np.int64)
        # raw values that overflowed their sub's bucket array; each entry
        # is one record (weight NOT applied), like BasicHist.Outliers
        self.outliers: list[int] = []

    def load_device_partial(self, count, wv_sum, bucket_counts=None,
                            outlier_values=(), vmin=None, vmax=None,
                            samples=0):
        count = int(count)
        if count:
            self.avg = (self.avg * self.count + float(wv_sum)) / (self.count + count)
        self.count += count
        self.samples += int(samples)
        if bucket_counts is not None and self.percentile_mode:
            self.values += np.asarray(bucket_counts, dtype=np.int64)
        self.outliers.extend(int(v) for v in outlier_values)
        if vmin is not None and count:
            self.min = min(self.min, int(vmin))
        if vmax is not None and count:
            self.max = max(self.max, int(vmax))

    def clone(self) -> "MultiHist":
        h = MultiHist(self.info_min, self.info_max, self.hist_bucket,
                      self.percentile_mode)
        h.combine(self)
        return h

    def combine(self, other: "MultiHist") -> None:
        if len(self.values) == len(other.values):
            self.values = self.values + other.values
        self.outliers.extend(other.outliers)
        total = self.count + other.count
        if total:
            self.avg = (self.avg * (self.count / total)
                        + other.avg * (other.count / total))
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.samples += other.samples
        self.count = total

    def add_weighted_value(self, value: int, weight: int,
                           weight_mode: bool = False) -> None:
        """Port of MultiHist.AddWeightedValue (hist_multi.go:48-88): first
        matching sub-range (top first) takes the value; sub-bucket overflow
        becomes a recorded outlier folded into the sub's last slot."""
        if value > self.info_max * HIST_OUTLIER_FACTOR or value < self.info_min:
            return
        if weight_mode or weight > 1:
            self.samples += 1
            self.count += weight
        else:
            self.count += 1
        self.avg = self.avg + ((float(value) - self.avg) / self.count) * weight
        self.max = max(self.max, value)
        self.min = min(self.min, value)
        if not self.percentile_mode:
            return
        for (sub_min, sub_max, bs, nv, off) in self.subs:
            if sub_min <= value <= sub_max:
                bucket = (value - sub_min) // bs
                if bucket >= nv:
                    self.outliers.append(value)
                    bucket = nv - 1
                self.values[off + bucket] += weight
                break

    def mean(self) -> float:
        return self.avg

    def total_count(self) -> int:
        return self.count

    def get_sparse_buckets(self) -> dict[int, int]:
        """Union of per-subhist sparse buckets (hist_multi.go:184-200).
        NOTE the reference unions with plain overwrite for GetStrBuckets
        but += for GetSparseBuckets; sub ranges only share edge values."""
        ret: dict[int, int] = {}
        for (sub_min, _sub_max, bs, nv, off) in self.subs:
            chunk = self.values[off: off + nv]
            for k in np.nonzero(chunk)[0].tolist():
                key = k * bs + sub_min
                ret[key] = ret.get(key, 0) + int(chunk[k])
        for v in self.outliers:
            ret[v] = ret.get(v, 0) + 1
        return ret

    def get_str_buckets(self) -> dict[str, int]:
        """GetStrBuckets via sub GetStrBuckets with overwrite semantics
        (hist_multi.go:173-182) — includes zero buckets."""
        ret: dict[str, int] = {}
        for (sub_min, _sub_max, bs, nv, off) in self.subs:
            chunk = self.values[off: off + nv]
            for k in range(nv):
                ret[str(k * bs + sub_min)] = int(chunk[k])
        for v in self.outliers:
            ret[str(v)] = ret.get(str(v), 0) + 1
        return ret

    def get_percentiles(self) -> list[int]:
        """Port of MultiHist.GetPercentiles (hist_multi.go:90-131):
        walks the *sparse* buckets; total is the sparse sum, and the
        recorded percentile value is the bucket value itself."""
        if self.count == 0:
            return []
        all_buckets = self.get_sparse_buckets()
        keys = sorted(k for k, c in all_buckets.items() if c > 0)
        total = sum(all_buckets[k] for k in keys)
        percentiles = [0] * 101
        prev_p = 0
        count = 0
        for k in keys:
            count += all_buckets[k]
            p = (100 * count) // total
            for ip in range(prev_p, min(p, 100) + 1):
                percentiles[ip] = k
            if p <= 100:
                percentiles[p] = k
            prev_p = p
        return percentiles[:100]

    def get_stddev(self) -> float:
        """hist_multi.go:144-158 — no outlier terms, sparse buckets only."""
        if self.count == 0:
            return 0.0
        sum_variance = 0.0
        for val, cnt in self.get_sparse_buckets().items():
            delta = float(val) - self.avg
            sum_variance += delta * delta * (cnt / self.count)
        return math.sqrt(sum_variance)

    def range_(self):
        return self.min, self.max


# ---------------------------------------------------------------------------
# t-digest (-tdigest): the reference's optional build-tag histogram
# (hist_tdigest.go:1-130, build tag `tdigest`, honeycombio/go-tdigest).
# Host-side merging t-digest (Dunning's k1 scale function) fed by the
# device's sparse (group, value, Σweight) pairs — the engine switches the
# hist agg to value-identity buckets so the digest sees (near-)exact
# values, not bucket midpoints.  Mirrors the reference surface exactly,
# including its quirks: Mean() returns the MEDIAN (hist_tdigest.go:61-63),
# StdDev() is 0 (:92-94), and GetStrBuckets()/GetIntBuckets() are empty
# (:105-119, "TODO: implement this!").
# ---------------------------------------------------------------------------

class TDigest:
    """Merging t-digest with the k1 scale function; compression=200
    bounds centroids to ~compression regardless of stream length."""

    def __init__(self, compression: int = 200):
        self.compression = compression
        self.means = np.zeros(0)
        self.weights = np.zeros(0)
        self._buf_v: list[float] = []
        self._buf_w: list[float] = []
        self._flip = False     # alternate merge direction per compress

    def add_many(self, values, weights) -> None:
        self._buf_v.extend(float(v) for v in values)
        self._buf_w.extend(float(w) for w in weights)
        if len(self._buf_v) > 8 * self.compression:
            self._compress()

    def merge(self, other: "TDigest") -> None:
        other._compress()
        self._buf_v.extend(other.means.tolist())
        self._buf_w.extend(other.weights.tolist())
        self._compress()

    def _compress(self) -> None:
        if not self._buf_v and len(self.means) <= 2 * self.compression:
            return
        v = np.concatenate([self.means, np.asarray(self._buf_v)])
        w = np.concatenate([self.weights, np.asarray(self._buf_w)])
        self._buf_v, self._buf_w = [], []
        if v.size == 0:
            return
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
        # alternating the merge direction between compress passes avoids
        # the systematic tail bias of always sweeping left-to-right
        # (Dunning's merging t-digest, computeCentroids alternation)
        self._flip = not self._flip
        if self._flip:
            v, w = v[::-1], w[::-1]
        total = w.sum()
        # k1 scale: k(q) = (delta / 2pi) * asin(2q - 1); merge adjacent
        # centroids while the merged centroid spans < 1 unit of k
        d = float(self.compression)
        out_m, out_w = [], []
        cur_m, cur_w = v[0], w[0]
        q0 = 0.0

        def k(q):
            return d / (2 * math.pi) * math.asin(
                max(-1.0, min(1.0, 2 * q - 1)))

        for i in range(1, v.size):
            q2 = q0 + (cur_w + w[i]) / total
            if k(q2) - k(q0) <= 1.0:
                cur_m += (v[i] - cur_m) * (w[i] / (cur_w + w[i]))
                cur_w += w[i]
            else:
                out_m.append(cur_m)
                out_w.append(cur_w)
                q0 += cur_w / total
                cur_m, cur_w = v[i], w[i]
        out_m.append(cur_m)
        out_w.append(cur_w)
        if self._flip:
            out_m.reverse()
            out_w.reverse()
        self.means = np.asarray(out_m)
        self.weights = np.asarray(out_w)

    def centroids(self):
        """-> (means list, weights list) after flushing the buffer —
        the serialization form (cache / node wire protocol)."""
        self._compress()
        return self.means.tolist(), self.weights.tolist()

    def quantile(self, q: float) -> float:
        self._compress()
        if self.means.size == 0:
            return 0.0
        if self.means.size == 1:
            return float(self.means[0])
        total = self.weights.sum()
        target = q * total
        # centroid i covers cumulative midpoint cum_i = sum(w[:i]) + w[i]/2
        cum = np.cumsum(self.weights) - self.weights / 2
        if target <= cum[0]:
            return float(self.means[0])
        if target >= cum[-1]:
            return float(self.means[-1])
        i = int(np.searchsorted(cum, target) - 1)
        frac = (target - cum[i]) / (cum[i + 1] - cum[i])
        return float(self.means[i] + frac * (self.means[i + 1]
                                             - self.means[i]))


class TDigestHist:
    """Reference-surface histogram backed by a TDigest
    (hist_tdigest.go:16-130)."""

    percentile_mode = True

    def __init__(self, info_min: int, info_max: int, hist_bucket: int = 0,
                 percentile_mode: bool = True, compression: int = 200):
        self.info_min = int(info_min)
        self.info_max = int(info_max)
        self.hist_bucket = hist_bucket
        self.count = 0
        self.samples = 0
        self.avg = 0.0             # true running mean (for sum())
        self.td = TDigest(compression)
        self.outliers: list[int] = []
        self.underliers: list[int] = []
        self.values = np.zeros(0, dtype=np.int64)   # no bucket array

    def load_device_partial(self, count, wv_sum, bucket_counts=None,
                            outlier_values=(), vmin=None, vmax=None,
                            samples=0):
        count = int(count)
        if count:
            self.avg = (self.avg * self.count + float(wv_sum)) / (
                self.count + count)
        self.count += count
        self.samples += int(samples)
        self.outliers.extend(int(v) for v in outlier_values)

    def add_weighted_values(self, values, weights) -> None:
        """Feed exact (value, Σweight) pairs from the device's sparse
        hist rows."""
        self.td.add_many(values, weights)

    def add_weighted_value(self, value: int, weight: int,
                           weight_mode: bool = False) -> None:
        """Row-at-a-time path (RecordValues, hist_tdigest.go:66-73)."""
        if value > self.info_max * HIST_OUTLIER_FACTOR or \
                value < self.info_min:
            return
        if weight_mode or weight > 1:
            self.samples += 1
            self.count += weight
        else:
            self.count += 1
        self.avg += ((float(value) - self.avg) / self.count) * weight
        self.td.add_many([value], [weight])

    def clone(self) -> "TDigestHist":
        h = TDigestHist(self.info_min, self.info_max, self.hist_bucket)
        h.combine(self)
        return h

    def combine(self, other: "TDigestHist") -> None:
        """Combine (hist_tdigest.go:83-86) + count bookkeeping."""
        total = self.count + other.count
        if total:
            self.avg = (self.avg * (self.count / total)
                        + other.avg * (other.count / total))
        self.count = total
        self.samples += other.samples
        self.outliers.extend(other.outliers)
        self.td.merge(other.td)

    # --- reference accessors (incl. quirks) ---
    def mean(self) -> float:
        """hist_tdigest.go:61-63: Mean() is Quantile(0.5) — the MEDIAN."""
        return self.td.quantile(0.5)

    def total_count(self) -> int:
        return self.count

    def sum(self) -> float:
        return self.avg * float(self.count)

    def get_percentiles(self) -> list[int]:
        """hist_tdigest.go:96-103."""
        if self.count == 0:
            return []
        return [int(self.td.quantile(i / 100.0)) for i in range(100)]

    def get_stddev(self) -> float:
        """hist_tdigest.go:92-94 returns 0."""
        return 0.0

    def get_sparse_buckets(self) -> dict[int, int]:
        return {}      # hist_tdigest.go:112-119 "TODO: implement this!"

    def get_str_buckets(self) -> dict[str, int]:
        return {}      # hist_tdigest.go:105-110 "TODO: implement this!"

    def range_(self):
        """hist_tdigest.go:121-123: quantile(0)..quantile(1)."""
        return int(self.td.quantile(0.0)), int(self.td.quantile(1.0))
