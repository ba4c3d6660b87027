"""Sparsity schedules → per-(layer, projection) threshold arrays.

Builds the `[n_layers, 7]` threshold array the model consumes, from
calibration histograms (ours or TEAL's shipped `models/<M>/histograms/`)
plus either a uniform sparsity level (reference `set_uniform_sparsity`,
`teal/model.py:144-149`) or a greedy per-layer schedule read from
`lookup/layer-<i>/results.csv` (reference `get_layer_greedy_sparsities`,
`utils/utils.py:243-258`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from teal_jax.config import ModelConfig, PROJS, PROJ_GROUP
from teal_jax.ops.distribution import (
    Distribution,
    load_histograms,
    threshold_for_sparsity,
)

# CSV schema written by the greedy optimizer (reference `teal/greedyopt.py:
# 120-126`): Effective Sparsity, Activation Error, Baseline Error, then the
# seven per-projection sparsities in PROJS order.
CSV_HEADER = ["Effective Sparsity", "Activation Error", "Baseline Error"] + list(PROJS)


def load_layer_distributions(hist_root: str, layer: int) -> Dict[str, Distribution]:
    """Distributions for one layer keyed '<module>/<htype>'. Missing
    histograms are skipped (MoE calibrations record no shared mlp h2 —
    experts run dense; `grab_acts.calibrate`)."""
    out = {}
    for module in ("self_attn", "mlp"):
        hists = load_histograms(os.path.join(hist_root, f"layer-{layer}", module))
        for htype in ("h1", "h2"):
            if htype in hists:
                out[f"{module}/{htype}"] = Distribution(hists[htype])
    return out


def proj_distribution(distrs: Dict[str, Distribution], proj: str) -> Distribution:
    module, htype = PROJ_GROUP[proj]
    return distrs[f"{module}/{htype}"]


def thresholds_from_sparsities(
    hist_root: str, cfg: ModelConfig, sparsities: np.ndarray
) -> np.ndarray:
    """sparsities: [n_layers, 7] → thresholds [n_layers, 7] (float32)."""
    sparsities = np.asarray(sparsities, np.float64)
    th = np.zeros((cfg.n_layers, len(PROJS)), np.float32)
    for l in range(cfg.n_layers):
        distrs = load_layer_distributions(hist_root, l)
        for j, proj in enumerate(PROJS):
            module, htype = PROJ_GROUP[proj]
            if f"{module}/{htype}" not in distrs:
                continue   # MoE: no shared mlp h2 — threshold stays 0
            th[l, j] = threshold_for_sparsity(
                proj_distribution(distrs, proj), float(sparsities[l, j])
            )
    return th


def thresholds_for_uniform(
    hist_root: str,
    cfg: ModelConfig,
    sparsity: float,
    *,
    mlp_sparsity: Optional[float] = None,
    self_attn_sparsity: Optional[float] = None,
) -> np.ndarray:
    """Uniform sparsity across layers; optional per-module override
    (reference `set_mlp_sparsity`/`set_self_attn_sparsity`,
    `teal/model.py:131-142`)."""
    s = np.zeros((cfg.n_layers, len(PROJS)), np.float64)
    for j, proj in enumerate(PROJS):
        module, _ = PROJ_GROUP[proj]
        if module == "mlp" and mlp_sparsity is not None:
            s[:, j] = mlp_sparsity
        elif module == "self_attn" and self_attn_sparsity is not None:
            s[:, j] = self_attn_sparsity
        else:
            s[:, j] = sparsity
    return thresholds_from_sparsities(hist_root, cfg, s)


def get_layer_greedy_sparsities(
    lookup_root: str, cfg: ModelConfig, level: float
) -> np.ndarray:
    """Per-layer sparsities [n_layers, 7]: for each layer pick the greedy
    CSV row whose effective sparsity is closest to `level`."""
    import csv

    out = np.zeros((cfg.n_layers, len(PROJS)), np.float64)
    for l in range(cfg.n_layers):
        path = os.path.join(lookup_root, f"layer-{l}", "results.csv")
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        # the first row at the minimum distance wins ties
        row = min(rows, key=lambda r: abs(float(r["Effective Sparsity"])
                                          - level))
        for j, proj in enumerate(PROJS):
            out[l, j] = float(row[proj])
    return out


def proj_group_size(cfg: ModelConfig, proj: str, block_size: int) -> int:
    """The effective group size of a projection under the group rule
    (`sparsify.effective_block_size` doubles deep input dims' group
    size), so group-score thresholds must be calibrated at that size —
    max-|x| over 64 channels is stochastically larger than over 32, and a
    32-calibrated threshold would under-drop."""
    from teal_jax.ops.sparsify import effective_block_size

    return effective_block_size(block_size, cfg.proj_shape(proj)[0])


def model_group_sizes(cfg: ModelConfig, block_size: int = 32):
    """All runtime-effective group sizes this model needs calibrated
    (what `calibrate(group_sizes=...)` should include)."""
    return tuple(sorted({proj_group_size(cfg, p, block_size) for p in PROJS}))


def _abs_icdf_tail(d: Distribution, q: float, q0: float = 0.98) -> float:
    """|x| quantile robust to the histogram's 1%/99% clamp: TEAL's capture
    protocol clamps at the 1%/99% order statistics (`grab_acts`), so ~1%
    of the mass is an atom at the edge bin and empirical quantiles above
    ~q0 are unresolvable (large-G group thresholds need e.g. the 99.46th
    percentile: 0.5^(1/128)). Beyond q0 we extrapolate with the
    better-fitting moment family (h1≈Gaussian / h2≈Laplace on the shipped
    artifacts, `calibration/analysis.py`), anchored to the empirical
    quantile at q0 so only the tail SHAPE comes from the fit:
    t(q) = t_emp(q0) * t_fit(q) / t_fit(q0)."""
    if q <= q0:
        return d.abs_icdf(q)
    import math
    from statistics import NormalDist

    from teal_jax.calibration.analysis import fit_distribution

    r = fit_distribution(d)
    if r.better == "gaussian":
        def tf(p):
            return r.std * NormalDist().inv_cdf((1.0 + p) / 2.0)
    else:
        def tf(p):
            return -r.laplace_b * math.log1p(-p)
    return d.abs_icdf(q0) * tf(q) / tf(q0)


def group_thresholds_from_sparsities(
    hist_root: str,
    cfg: ModelConfig,
    sparsities: np.ndarray,
    block_size: int = 32,
    iid_fallback: bool = True,
) -> np.ndarray:
    """sparsities [n_layers, 7] → [n_layers, 7] GROUP-SCORE thresholds:
    a group is dropped when its max-|x| score <= t, with t =
    icdf(sparsity) of the calibrated group-score distribution (scores are
    non-negative, so the dropped fraction is the lower `s` quantile — the
    structured analog of the elementwise `icdf(0.5 + s/2)` rule).

    Each projection's thresholds come from the histogram calibrated at
    its RUNTIME-effective group size (see `proj_group_size`). Per-layer
    non-uniform schedules are first-class: thresholds are data ([L, 7])
    in the fast engine, so greedy per-layer profiles run at full speed
    (the reference never wired greedy into its fast engine,
    README.md:109).

    When a group-score histogram is absent (TEAL's shipped
    `models/<M>/histograms/` are elementwise-only — `grab_acts.py` never
    recorded group scores), `iid_fallback` derives the threshold from
    the ELEMENTWISE histogram via the order statistic of the group max:
    P(max over G of |x| <= t) = F_|x|(t)^G, so the threshold dropping a
    fraction `s` of groups is abs_icdf(s^(1/G)). Exact for independent
    channels; correlated channels make the true drop rate slightly
    higher (the channel permutation, which clusters correlated channels,
    moves it back toward iid — docs/ACCURACY.md). Self-calibrated group
    histograms (CLI `calibrate`, which records `h{1,2}_g<G>`) remain the
    exact route."""
    sparsities = np.asarray(sparsities, np.float64)
    th = np.zeros((cfg.n_layers, len(PROJS)), np.float32)
    gsizes = {p: proj_group_size(cfg, p, block_size) for p in PROJS}
    for l in range(cfg.n_layers):
        hists = {}
        for module in ("self_attn", "mlp"):
            hists[module] = load_histograms(
                os.path.join(hist_root, f"layer-{l}", module)
            )
        distrs = {}
        for j, proj in enumerate(PROJS):
            module, htype = PROJ_GROUP[proj]
            G = gsizes[proj]
            key = f"{htype}_g{G}"
            s = float(sparsities[l, j])
            if htype not in hists[module] and key not in hists[module]:
                continue   # MoE: no shared mlp h2 — threshold stays 0
            if key in hists[module]:
                if key + module not in distrs:
                    distrs[key + module] = Distribution(hists[module][key])
                th[l, j] = distrs[key + module].icdf(s) if s > 0 else 0.0
            elif iid_fallback:
                if htype + module not in distrs:
                    distrs[htype + module] = Distribution(
                        hists[module][htype])
                th[l, j] = (
                    _abs_icdf_tail(distrs[htype + module], s ** (1.0 / G))
                    if s > 0 else 0.0
                )
            else:
                raise KeyError(
                    f"{key} not in layer-{l}/{module} histograms — "
                    "re-run calibration with group_sizes including "
                    f"{G} (see model_group_sizes)"
                )
    return th


def group_thresholds_for_uniform(
    hist_root: str,
    cfg: ModelConfig,
    sparsity: float,
    group_size: int = 32,
) -> np.ndarray:
    """[n_layers, 7] group-score thresholds at one uniform sparsity
    (see `group_thresholds_from_sparsities`)."""
    if sparsity <= 0:
        return np.zeros((cfg.n_layers, len(PROJS)), np.float32)
    s = np.full((cfg.n_layers, len(PROJS)), sparsity, np.float64)
    return group_thresholds_from_sparsities(hist_root, cfg, s, group_size)


def keep_fracs_from_greedy(
    lookup_root: str, cfg: ModelConfig, level: float
):
    """Per-projection keep fractions for the block fast engine's TOP-K
    mode from a greedy lookup: 1 - mean-over-layers of each projection's
    greedy sparsity at the given effective level (top-k capacities are
    compile-time constants, so the per-layer dimension is averaged).
    For per-layer-EXACT greedy schedules use the threshold mode instead
    (`group_thresholds_for_greedy` + `capacity_fracs_for_greedy`) — there
    the per-layer profile is data. Returns a 7-tuple in PROJS order."""
    sparsities = get_layer_greedy_sparsities(lookup_root, cfg, level)
    mean = np.clip(sparsities, 0.0, 1.0).mean(axis=0)
    return tuple(float(1.0 - m) for m in mean)


def group_thresholds_for_greedy(
    teal_root: str, cfg: ModelConfig, level: float, block_size: int = 32
) -> np.ndarray:
    """Per-layer greedy schedule → [n_layers, 7] group-score thresholds
    (threshold mode makes per-layer capacities DATA: the kernel's DMA
    loop only gathers surviving groups, so each layer reads exactly its
    own schedule's bytes under one static capacity bound)."""
    sparsities = get_layer_greedy_sparsities(
        os.path.join(teal_root, "lookup"), cfg, level
    )
    return group_thresholds_from_sparsities(
        os.path.join(teal_root, "histograms"), cfg, sparsities, block_size
    )


def capacity_fracs_for_greedy(
    lookup_root: str, cfg: ModelConfig, level: float, margin: float = 1.25
):
    """Static per-projection gather-capacity bound for a per-layer greedy
    schedule run in threshold mode: margin x the largest per-layer keep
    fraction of each projection. Returns a 7-tuple in PROJS order."""
    sparsities = get_layer_greedy_sparsities(lookup_root, cfg, level)
    keep = 1.0 - np.clip(sparsities, 0.0, 1.0)
    cap = np.minimum(1.0, keep.max(axis=0) * margin)
    return tuple(float(c) for c in cap)


def thresholds_for_greedy(
    teal_root: str, cfg: ModelConfig, level: float
) -> np.ndarray:
    """Thresholds from a calibration dir containing both `histograms/` and
    `lookup/` (the reference's `--teal_path` layout)."""
    sparsities = get_layer_greedy_sparsities(
        os.path.join(teal_root, "lookup"), cfg, level
    )
    return thresholds_from_sparsities(
        os.path.join(teal_root, "histograms"), cfg, sparsities
    )
