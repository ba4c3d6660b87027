"""Cross-validation against TEAL's real shipped calibration artifacts.

The reference ships 141 MB of histograms + greedy lookups for six models
(`models/<M>/...`). These tests load the REAL artifacts through our
loaders and check our threshold math against an independent torch
re-evaluation of the reference's icdf definition. Skipped when the
reference checkout isn't present.
"""

import os

import numpy as np
import pytest

REF = "/root/reference/models"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference artifacts not available"
)


def _ref_icdf_torch(counts, centers, q):
    """The reference's icdf math (`utils/utils.py:105-123`), evaluated
    directly with torch as an independent oracle."""
    import torch

    counts = torch.as_tensor(counts, dtype=torch.float64)
    centers = torch.as_tensor(centers, dtype=torch.float64)
    total = counts.sum()
    cum = torch.cumsum(counts, 0)
    target = q * total
    idx = int(torch.searchsorted(cum, target))
    if idx == 0:
        return float(centers[0])
    if idx >= len(centers):
        return float(centers[-1])
    frac = (target - cum[idx - 1]) / (cum[idx] - cum[idx - 1])
    return float(centers[idx - 1] + frac * (centers[idx] - centers[idx - 1]))


@pytest.mark.parametrize("model,layer,module", [
    ("Llama-2-7B", 0, "mlp"),
    ("Llama-2-7B", 10, "self_attn"),
    ("Llama-3-8B", 5, "mlp"),
    ("Mistral-7B", 3, "self_attn"),
])
def test_icdf_matches_reference_on_shipped_histograms(model, layer, module):
    from teal_jax.ops.distribution import load_histograms, Distribution

    path = os.path.join(REF, model, "histograms", f"layer-{layer}", module)
    if not os.path.isdir(path):
        pytest.skip(f"{path} missing")
    hists = load_histograms(path)
    assert "h1" in hists and "h2" in hists
    for htype in ("h1", "h2"):
        d = Distribution(hists[htype])
        for s in (0.25, 0.4, 0.5, 0.65):
            ours = d.icdf(0.5 + s / 2)
            theirs = _ref_icdf_torch(
                hists[htype].counts, hists[htype].centers, 0.5 + s / 2
            )
            assert ours == pytest.approx(theirs, rel=1e-6, abs=1e-9), (
                model, layer, module, htype, s
            )


def test_shipped_histograms_have_expected_shape():
    from teal_jax.ops.distribution import load_histograms

    path = os.path.join(REF, "Llama-2-7B", "histograms", "layer-0", "mlp")
    hists = load_histograms(path)
    # 10k bins, h1/h2 (+ legacy h1.5 key in shipped artifacts)
    assert hists["h1"].counts.shape == (10000,)
    assert hists["h2"].centers.shape == (10000,)


def test_greedy_lookup_reader_on_shipped_csvs():
    from teal_jax.config import get_model_config
    from teal_jax.calibration import get_layer_greedy_sparsities
    from teal_jax.calibration.greedyopt import proj_weights, effective_sparsity
    from teal_jax.config import PROJS

    lookup = os.path.join(REF, "Llama-2-7B", "lookup")
    if not os.path.isdir(lookup):
        pytest.skip("no shipped lookup")
    cfg = get_model_config("7B")
    s = get_layer_greedy_sparsities(lookup, cfg, 0.5)
    assert s.shape == (cfg.n_layers, 7)
    assert np.all(s >= 0) and np.all(s <= 1.05)
    w = proj_weights(cfg)
    effs = [
        effective_sparsity({p: s[l, j] for j, p in enumerate(PROJS)}, w)
        for l in range(cfg.n_layers)
    ]
    # each layer's schedule should sit near the requested effective level
    assert np.median(np.abs(np.asarray(effs) - 0.5)) < 0.05


def test_thresholds_from_shipped_artifacts_full_model():
    """End-to-end: uniform thresholds for all 32 layers of Llama-2-7B from
    the real shipped histograms."""
    from teal_jax.config import get_model_config
    from teal_jax.calibration import thresholds_for_uniform

    hist_root = os.path.join(REF, "Llama-2-7B", "histograms")
    cfg = get_model_config("7B")
    th = thresholds_for_uniform(hist_root, cfg, 0.5)
    assert th.shape == (32, 7)
    assert np.all(th > 0) and np.all(np.isfinite(th))
    # thresholds are per-group: q/k/v share h1, gate/up share h1
    assert np.allclose(th[:, 0], th[:, 1]) and np.allclose(th[:, 4], th[:, 5])


def test_group_threshold_iid_fallback_on_shipped_histograms():
    """TEAL's shipped histograms are elementwise-only; the block fast
    path's group-score thresholds fall back to the iid order-statistic
    mapping t = abs_icdf(s^(1/G)). Check (a) the full greedy->group
    pipeline runs on the real Mistral-7B artifacts, and (b) the mapping
    is self-consistent: sampling iid from the elementwise histogram and
    grouping, the fraction of groups with max-|x| <= t is ~s."""
    from teal_jax.config import get_model_config
    from teal_jax.calibration.thresholds import (
        capacity_fracs_for_greedy,
        group_thresholds_for_greedy,
    )
    from teal_jax.ops.distribution import Distribution, load_histograms

    root = os.path.join(REF, "Mistral-7B")
    if not os.path.isdir(root):
        pytest.skip("Mistral artifacts missing")
    cfg = get_model_config("Mistral-7B")
    th = group_thresholds_for_greedy(root, cfg, 0.5, block_size=128)
    assert th.shape == (cfg.n_layers, 7)
    assert np.all(th > 0) and np.all(np.isfinite(th))
    caps = capacity_fracs_for_greedy(os.path.join(root, "lookup"), cfg, 0.5)
    assert all(0 < c <= 1 for c in caps)

    # (b) in-range self-consistency on one layer's h1: at G=32 the needed
    # quantile (0.5^(1/32) = .9786) is below the histogram's 1% clamp, so
    # resampling the histogram itself must reproduce the drop rate
    hists = load_histograms(
        os.path.join(root, "histograms", "layer-3", "self_attn"))
    d = Distribution(hists["h1"])
    G, s = 32, 0.5
    t = d.abs_icdf(s ** (1.0 / G))
    rng = np.random.default_rng(0)
    p = np.asarray(hists["h1"].counts, np.float64)
    vals = rng.choice(np.asarray(hists["h1"].centers), size=(8192, G),
                      p=p / p.sum())
    drop = float(np.mean(np.abs(vals).max(axis=1) <= t))
    assert abs(drop - s) < 0.05, (drop, t)


def test_group_threshold_tail_extrapolation_gaussian_truth():
    """Beyond the histogram's 1%/99% clamp (large-G quantiles) the iid
    fallback extrapolates with the fitted family. Ground truth: Gaussian
    samples captured under TEAL's clamped-histogram protocol; the G=128
    threshold must reproduce the TRUE Gaussian group-drop rate, which
    the clamped empirical quantile alone cannot (it lands at ~0.99^128
    = 0.28)."""
    from teal_jax.calibration.thresholds import _abs_icdf_tail
    from teal_jax.ops.distribution import Distribution

    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.7, size=2_000_000)
    d = Distribution.from_values(x)    # TEAL protocol: 1%/99% clamp
    G, s = 128, 0.5
    t = _abs_icdf_tail(d, s ** (1.0 / G))
    fresh = np.abs(rng.normal(0.0, 1.7, size=(8192, G))).max(axis=1)
    drop = float(np.mean(fresh <= t))
    assert abs(drop - s) < 0.06, (drop, t)
    # monotone in s, and s=0 -> everything kept
    t40 = _abs_icdf_tail(d, 0.4 ** (1.0 / G))
    assert t40 < t
