"""Intra-class correlation across group-by rows (reference: src/lib/stats.go).

ICC = mean-square-between / (mean-square-between + mean-square-within),
computed by analysis of variance over the per-group histograms
(stats.go:23-100).  Like the reference this is an auxiliary analytics
helper, not wired to the CLI.
"""

from __future__ import annotations

from .hist import BasicHist


def calculate_icc(qr, params) -> dict[str, float]:
    """qr: engine.QueryResults with populated hists; params: QueryParams.

    Mirrors QuerySpec.CalculateICC (stats.go:23): within-group variance is
    taken from the cumulative histogram per result row (as the reference
    does — note it consults `cumulative.StdDev()` inside the loop,
    stats.go:75-77); between-group variance from a histogram of per-group
    means weighted by group counts.
    """
    iccs: dict[str, float] = {}
    results = list(qr.results.values())
    for agg in params.aggs:
        cumulative = (qr.cumulative.hists.get(agg.col)
                      if qr.cumulative is not None else None)
        if cumulative is None:
            continue

        total_variance = cumulative.get_stddev() ** 2

        # min/max of the group means bound the between-groups histogram
        # (stats.go:36-48)
        min_avg = total_variance
        max_avg = 0.0
        group_hists = []
        for res in results:
            h = res.hists.get(agg.col)
            if h is None:
                continue
            group_hists.append(h)
            min_avg = min(h.mean(), min_avg)
            max_avg = max(h.mean(), max_avg)

        between = BasicHist(int(min_avg), int(max_avg))
        ss_within = 0.0
        for h in group_hists:
            # the reference adds the *cumulative* variance once per group
            # (stats.go:75-77) — replicated verbatim for parity
            ss_within += cumulative.get_stddev() ** 2
            between.add_weighted_value(int(h.mean()), h.total_count())

        icc = 1.0
        k = len(results)
        if k > 1:
            # MSB = hist variance of the weighted group means / (K-1)
            # (stats.go:85-90)
            mean_between = between.get_stddev() ** 2 / float(k - 1)
            ss_within_count = float(cumulative.total_count() - k)
            if ss_within_count > 0:
                mean_within = ss_within / ss_within_count
                denom = mean_between + mean_within
                icc = mean_between / denom if denom > 0 else 1.0
        iccs[agg.col] = icc
    return iccs
