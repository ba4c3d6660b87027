"""Empirical activation distributions: histogram build, cdf/icdf, thresholds.

This is the calibration→threshold mapping at the heart of TEAL: activations
of each (layer, projection-group) are summarized as a 10,000-bin histogram
with 1% outlier clamping, and the sparsity→threshold map is the inverse
empirical CDF evaluated at `0.5 + s/2` (zero-mean unimodal assumption, so
zeroing `|x| <= t` removes the central `s` probability mass).

Behavioral parity targets (reference, studied not copied):
  - histogram construction: `utils/utils.py:145-173` (`find_histogram`) —
    sorted values, bounds at the 1%/99% order statistics, `num_bins-1`
    uniform interior edges plus two catch-all outer bins ending at min/max.
  - icdf: `utils/utils.py:105-123` — searchsorted over cumulative counts
    with linear interpolation between bin centers.
  - cdf: `utils/utils.py:101-102`; pdf (Gaussian KDE): `utils/utils.py:85-99`.
  - abs_icdf: `gpt-fast/distribution.py:68-105`.

Host-side math is numpy; `accumulate_counts` is jit-friendly for online
on-device histogram capture (replacing the reference's store-all-activations
approach, `utils/utils.py:134-136`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import jax.numpy as jnp
import numpy as np

DEFAULT_NUM_BINS = 10000
DEFAULT_OUTLIER_THRESHOLD = 0.01


@dataclass
class Histogram:
    """counts[i] covers [edges[i], edges[i+1]); centers are bin midpoints."""

    counts: np.ndarray   # [num_bins] float64
    centers: np.ndarray  # [num_bins] float32/float64
    edges: Optional[np.ndarray] = None  # [num_bins + 1], kept when known

    @property
    def num_bins(self) -> int:
        return int(self.counts.shape[0])


def make_edges(
    sorted_values: np.ndarray,
    num_bins: int = DEFAULT_NUM_BINS,
    outlier_threshold: float = DEFAULT_OUTLIER_THRESHOLD,
) -> np.ndarray:
    """Bin edges from sorted data: uniform between the outlier-clamped
    bounds, plus catch-all outer bins reaching the true min/max."""
    n = len(sorted_values)
    k = int(outlier_threshold * n)
    lower = sorted_values[k]
    upper = sorted_values[-k] if k > 0 else sorted_values[-1]
    main = np.linspace(lower, upper, num_bins - 1)
    return np.concatenate(
        [[sorted_values[0]], main, [sorted_values[-1]]]
    ).astype(np.float64)


def _edges_from_stats(vmin, vmax, lower, upper, num_bins) -> np.ndarray:
    # float32 endpoints so linspace computes in float32, bit-identical to
    # make_edges on the float32 sorted array
    main = np.linspace(np.float32(lower), np.float32(upper), num_bins - 1)
    return np.concatenate(
        [[np.float32(vmin)], main, [np.float32(vmax)]]
    ).astype(np.float64)


def build_histogram(
    values: np.ndarray,
    num_bins: int = DEFAULT_NUM_BINS,
    outlier_threshold: float = DEFAULT_OUTLIER_THRESHOLD,
) -> Histogram:
    """10k-bin outlier-clamped histogram (reference `find_histogram`
    semantics). The hot path — hundreds of millions of values per
    histogram at 7B calibration scale — runs through the native C++
    kernel (`teal_jax/native`, O(n) order statistics + OpenMP counting,
    bit-identical to the numpy path, which remains as fallback)."""
    values = np.asarray(values, dtype=np.float32).ravel()
    n = len(values)
    k = int(outlier_threshold * n)

    from teal_jax.native import get_lib

    lib = get_lib()
    if lib is not None and n >= 2 and values.flags["C_CONTIGUOUS"]:
        import ctypes

        out4 = np.zeros(4, np.float32)
        k_hi = (n - k) if k > 0 else (n - 1)
        lib.teal_order_stats(
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            k, k_hi, out4.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        vmin, vmax, lower, upper = (float(out4[0]), float(out4[1]),
                                    float(out4[2]), float(out4[3]))
        edges = _edges_from_stats(vmin, vmax, lower, upper, num_bins)
        counts = np.zeros(num_bins, np.float64)
        lib.teal_histogram_count(
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            edges.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            num_bins,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    else:
        sv = np.sort(values)
        edges = make_edges(sv, num_bins, outlier_threshold)
        counts = np.histogram(values, bins=edges)[0].astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    return Histogram(
        counts=counts,
        centers=centers.astype(np.float32),
        edges=edges,
    )


def accumulate_counts(edges, values, counts):
    """jit-friendly streaming accumulation of histogram counts.

    `edges` are fixed ([B+1]); values outside [edges[0], edges[-1]] are
    clipped into the outer catch-all bins (the outer bins already extend to
    the min/max of the first calibration batch; clipping keeps later
    batches' rare extremes counted rather than dropped).
    """
    values = values.ravel()
    idx = jnp.searchsorted(edges, values, side="right") - 1
    idx = jnp.clip(idx, 0, edges.shape[0] - 2)
    return counts + jnp.zeros_like(counts).at[idx].add(1.0)


class Distribution:
    """Histogram-backed empirical distribution with pdf/cdf/icdf."""

    def __init__(self, histogram: Histogram):
        self.histogram = histogram
        self.centers = np.asarray(histogram.centers, dtype=np.float64)
        self.counts = np.asarray(histogram.counts, dtype=np.float64)
        self.total = float(self.counts.sum())
        self.cum = np.cumsum(self.counts)

    # -- construction helpers -------------------------------------------------

    @classmethod
    def from_values(cls, values, **kw) -> "Distribution":
        return cls(build_histogram(np.asarray(values), **kw))

    @classmethod
    def from_counts(cls, counts, centers) -> "Distribution":
        return cls(Histogram(np.asarray(counts, np.float64),
                             np.asarray(centers)))

    # -- queries --------------------------------------------------------------

    def pdf(self, x, bandwidth: Optional[float] = None):
        """Gaussian kernel-density estimate over bin centers (Silverman-style
        bandwidth as in the reference, computed over interior centers)."""
        if bandwidth is None:
            bandwidth = float(
                1.06 * np.std(self.centers[1:-1]) * (self.total - 2) ** (-1 / 5)
            )
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        z = (x[None, :] - self.centers[:, None]) / bandwidth
        kernel = np.exp(-0.5 * z**2) / (bandwidth * np.sqrt(2 * np.pi))
        return (kernel * self.counts[:, None]).sum(0) / self.total

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.interp(x, self.centers, self.cum / self.total)

    def icdf(self, q: float) -> float:
        """Inverse empirical CDF with linear interpolation between centers."""
        target = q * self.total
        idx = int(np.searchsorted(self.cum, target, side="left"))
        if idx == 0:
            return float(self.centers[0])
        if idx >= len(self.centers):
            return float(self.centers[-1])
        lo_c, hi_c = self.cum[idx - 1], self.cum[idx]
        lo_v, hi_v = self.centers[idx - 1], self.centers[idx]
        frac = (target - lo_c) / (hi_c - lo_c)
        return float(lo_v + frac * (hi_v - lo_v))

    def abs_icdf(self, q: float) -> float:
        """Inverse CDF of |X|: magnitude t with P(|X| <= t) = q.

        Folds the signed histogram about zero (parity with the unused helper
        at `gpt-fast/distribution.py:68-105`, but implemented by folding
        rather than two-sided search).
        """
        abs_centers = np.abs(self.centers)
        order = np.argsort(abs_centers, kind="stable")
        folded_centers = abs_centers[order]
        folded_cum = np.cumsum(self.counts[order])
        target = q * self.total
        idx = int(np.searchsorted(folded_cum, target, side="left"))
        if idx == 0:
            return float(folded_centers[0])
        if idx >= len(folded_centers):
            return float(folded_centers[-1])
        lo_c, hi_c = folded_cum[idx - 1], folded_cum[idx]
        frac = 0.0 if hi_c == lo_c else (target - lo_c) / (hi_c - lo_c)
        return float(
            folded_centers[idx - 1]
            + frac * (folded_centers[idx] - folded_centers[idx - 1])
        )


def threshold_for_sparsity(distr: Distribution, sparsity: float) -> float:
    """Magnitude threshold zeroing the central `sparsity` mass.

    `t = icdf(0.5 + s/2)`; 0 when s == 0 (reference `utils/utils.py:28-30`).
    """
    if sparsity == 0.0:
        return 0.0
    return distr.icdf(0.5 + sparsity / 2)


# -- artifact IO --------------------------------------------------------------

def save_histograms(path: str, hists: Dict[str, Histogram]) -> None:
    """Save histograms for one (layer, module) as an .npz plus a JSON index.

    Layout mirrors the reference's `histograms.pt` key scheme
    (`{h1, h1_centers, h2, h2_centers}`) so group naming stays compatible.
    """
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for key, h in hists.items():
        arrays[key] = h.counts.astype(np.float32)
        arrays[f"{key}_centers"] = h.centers.astype(np.float32)
    np.savez(os.path.join(path, "histograms.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"keys": sorted(hists)}, f)


def load_histograms(path: str) -> Dict[str, Histogram]:
    """Load histograms saved by `save_histograms` OR a reference-format
    `histograms.pt` (requires torch; lets us reuse TEAL's 141 MB of shipped
    calibration data under `models/<M>/histograms/`)."""
    npz = os.path.join(path, "histograms.npz")
    if os.path.exists(npz):
        data = np.load(npz)
        keys = [k for k in data.files if not k.endswith("_centers")]
        return {
            k: Histogram(
                counts=np.asarray(data[k], np.float64),
                centers=np.asarray(data[f"{k}_centers"], np.float32),
            )
            for k in keys
        }
    pt = os.path.join(path, "histograms.pt")
    if os.path.exists(pt):
        import torch  # CPU-only usage; artifact compatibility shim

        data = torch.load(pt, map_location="cpu", weights_only=True)
        keys = [k for k in data if not k.endswith("_centers")]
        return {
            k: Histogram(
                counts=np.asarray(data[k].float().numpy(), np.float64),
                centers=np.asarray(data[f"{k}_centers"].float().numpy(),
                                   np.float32),
            )
            for k in keys
        }
    raise FileNotFoundError(f"no histograms.npz or histograms.pt under {path}")


def load_distribution(path: str, hidden_type: str) -> Distribution:
    """Distribution for one hidden type ('h1'/'h2') from a histogram dir."""
    hists = load_histograms(path)
    if hidden_type not in hists:
        raise KeyError(f"{hidden_type!r} not in {sorted(hists)} at {path}")
    return Distribution(hists[hidden_type])
