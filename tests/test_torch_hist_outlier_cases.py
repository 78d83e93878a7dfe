"""K9 (hist_prep, hist_pairs) and K5 outlier_compact on chip_smoke.py's
corner cases (K9_CASES, K5_CASES; the card holds each kernel to its plain
version on the same cases at 65,536-row blocks): the port's plain versions
against the reference's functions on the same numpy batches, made
smaller, tolerance 0.

K9: the sorted strategy's plain versions (K7, the sorts, K8, hist_prep,
the stable pair-key sort, hist_pairs) against sybil_tpu.ops.scan.
_scan_sorted: hp_mask whole and the pair count, hp_bv, hp_w and hp_keys
at the rows hp_mask sets and at row R-1 (the rows the kernel writes and
the packed section's padding reads), the outlier mask, values and count
(_outlier_outputs); the pair key's width; a wrapping weight sum against
Python's exact one.  K5: outlier_compact_plain against _mask_positions and
the outlier section of pack_outputs, its key rows those of _front_end or
the given kmat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sybil_tpu.ops import scan as ref
from sybil_tpu_torch.ops import scan as port

C = 1024
SCAN_SORTED = jax.jit(ref._scan_sorted, static_argnums=(0,))


def _ref_config(fields):
    f = dict(fields)
    f["aggs"] = tuple(ref.AggSpec(**a) for a in f["aggs"])
    f["filters"] = tuple(ref.FilterSpec(**x) for x in f["filters"])
    return ref.ScanConfig(**f)


def _torch_cols(cols):
    return {k: (torch.from_numpy(v), torch.from_numpy(m))
            for k, (v, m) in cols.items()}


def _jax_cols(cols):
    return {k: (jnp.asarray(v), jnp.asarray(m)) for k, (v, m) in cols.items()}


@pytest.mark.parametrize("name", list(chip_smoke.K9_CASES))
def test_hist_pairs_case_matches_reference(name):
    fields, cols, nrec, fv, tb = chip_smoke.k9_case(name, C)
    cfg = _ref_config(fields)
    pcfg = port.config_from_fields(fields)
    out = SCAN_SORTED(cfg, _jax_cols(cols), jnp.asarray(nrec),
                      jnp.asarray(fv), (), jnp.asarray(tb, jnp.int64), {})
    tcols = _torch_cols(cols)
    front = port.sorted_front_plain(pcfg, tcols, torch.from_numpy(nrec),
                                    torch.from_numpy(fv), (), tb)
    k8 = port.segment_reduce_plain(pcfg, tcols, front,
                                   port.sort_rows(pcfg, front), tb)
    prep = port.hist_prep_plain(pcfg, 0, tcols, k8)
    assert prep["pairkey"].dtype == port.pair_key_dtype(pcfg, 0)
    assert (prep["w"] is None) == (not pcfg.weight_col)
    spk, si2 = torch.sort(prep["pairkey"], stable=True)
    hp = port.hist_pairs_plain(pcfg, 0, spk, si2, prep["w"], k8["kmat"])

    mask = np.asarray(out["agg0_hp_mask"])
    R = mask.size
    np.testing.assert_array_equal(hp["hp_mask"].numpy(), mask)
    assert int(hp["npairs"][0]) == int(mask.sum())
    rows = np.append(np.flatnonzero(mask[:R - 1]), R - 1)
    for key in ("hp_bv", "hp_w", "hp_keys"):
        np.testing.assert_array_equal(hp[key].numpy()[rows],
                                      np.asarray(out[f"agg0_{key}"])[rows],
                                      err_msg=key)
    if pcfg.track_outliers:
        np.testing.assert_array_equal(prep["out_mask"].numpy(),
                                      np.asarray(out["agg0_out_mask"]))
        np.testing.assert_array_equal(prep["out_val"].numpy(),
                                      np.asarray(out["agg0_out_val"]))
        assert int(prep["nout"][0]) == int(out["agg0_nout"])
    else:
        assert prep["out_mask"] is None and prep["nout"] is None
    chip_smoke.k9_case_expect(name, pcfg, prep, hp, C // 4)
    if name == "weights of +-2^62 wrap mod 2^64":
        # the exact sums in Python integers: some leave int64, and each
        # hp_w is its sum mod 2^64
        sent = (pcfg.max_groups + 1) * pcfg.aggs[0].num_values
        w = prep["w"][si2].tolist()
        keys = spk.tolist()
        exact, start = {}, 0
        for i, (k, x) in enumerate(zip(keys, w)):
            if i == 0 or k != keys[i - 1]:
                start = i
            if k < sent:
                exact[start] = exact.get(start, 0) + x
        assert any(not -2 ** 63 <= x < 2 ** 63 for x in exact.values())
        got = hp["hp_w"].numpy()
        for start, x in exact.items():
            assert int(got[start]) == (x + 2 ** 63) % 2 ** 64 - 2 ** 63


@pytest.mark.parametrize("name", list(chip_smoke.K5_CASES))
def test_outlier_compact_case_matches_reference(name):
    fields, cols, mask, vals, kmat, W, tb = chip_smoke.k5_case(name, C)
    cfg = _ref_config(fields)
    pcfg = port.config_from_fields(fields)
    R = mask.size
    kmax = min(pcfg.max_out, R)
    main = torch.zeros((kmax + 5, W), dtype=torch.int64)
    port.outlier_compact_plain(
        pcfg, None if cols is None else _torch_cols(cols),
        torch.from_numpy(mask), torch.from_numpy(vals), main, 2, tb,
        kmat=None if kmat is None else torch.from_numpy(kmat))

    if kmat is None:
        B = cols["k0"][0].shape[0]
        keys = ref._front_end(cfg, _jax_cols(cols),
                              jnp.full((B,), cols["k0"][0].shape[1],
                                       jnp.int32),
                              jnp.zeros((0,), jnp.int64), (),
                              jnp.asarray(tb, jnp.int64), None)[5]
        key_rows = jnp.stack(keys, axis=1)
    else:
        key_rows = jnp.asarray(kmat)
    idx, live = ref._mask_positions(jnp.asarray(mask), kmax)
    block = np.asarray(jnp.concatenate(
        [key_rows[idx], jnp.asarray(vals)[idx][:, None],
         live[:, None].astype(jnp.int64)], axis=1))
    K = block.shape[1] - 2
    assert K == pcfg.n_key_cols
    got = main.numpy()
    np.testing.assert_array_equal(got[2:2 + kmax, :K + 2], block)
    assert not got[2:2 + kmax, K + 2:].any()
    assert not got[:2].any() and not got[2 + kmax:].any()
    # each case reaches the edge it is named for
    n = int(mask.sum())
    if name.startswith(("every row live", "kmat keys, every row",
                        "live rows from tile 3", "max_out 5")):
        assert n > kmax
    if name == "exactly kmax live rows":
        assert n == kmax
    if "R-1" in name:
        assert mask[R - 1] and n < kmax
        assert (got[2 + n:2 + kmax, :K + 1] == block[n - 1, :K + 1]).all()
    if name == "a 600-word row (past the shared copy)":
        assert W > 512
