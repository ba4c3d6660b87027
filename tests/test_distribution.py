"""Distribution/histogram math vs analytic ground truth.

The icdf-based threshold rule `t = icdf(0.5 + s/2)` must reproduce analytic
quantiles for known distributions (the reference has no such tests; its
de-facto validation is end-to-end perplexity)."""

import numpy as np
import pytest
from scipy import stats

from teal_jax.ops.distribution import (
    Distribution,
    build_histogram,
    accumulate_counts,
    threshold_for_sparsity,
    save_histograms,
    load_histograms,
)


@pytest.fixture(scope="module")
def gaussian_values():
    rng = np.random.default_rng(0)
    return rng.normal(0.0, 2.0, size=2_000_000).astype(np.float32)


def test_icdf_matches_analytic_gaussian(gaussian_values):
    d = Distribution.from_values(gaussian_values)
    for q in [0.6, 0.7, 0.75, 0.9, 0.95]:
        expected = stats.norm.ppf(q, scale=2.0)
        assert d.icdf(q) == pytest.approx(expected, rel=0.02)


def test_icdf_matches_analytic_laplace():
    rng = np.random.default_rng(1)
    vals = rng.laplace(0.0, 1.5, size=2_000_000).astype(np.float32)
    d = Distribution.from_values(vals)
    for q in [0.6, 0.75, 0.9]:
        expected = stats.laplace.ppf(q, scale=1.5)
        assert d.icdf(q) == pytest.approx(expected, rel=0.02)


def test_threshold_for_sparsity_zeroes_central_mass(gaussian_values):
    d = Distribution.from_values(gaussian_values)
    for s in [0.25, 0.5, 0.7]:
        t = threshold_for_sparsity(d, s)
        frac_zeroed = np.mean(np.abs(gaussian_values) <= t)
        assert frac_zeroed == pytest.approx(s, abs=0.01)
    assert threshold_for_sparsity(d, 0.0) == 0.0


def test_cdf_icdf_roundtrip(gaussian_values):
    d = Distribution.from_values(gaussian_values)
    for q in [0.55, 0.75, 0.9]:
        assert d.cdf(d.icdf(q)) == pytest.approx(q, abs=0.005)


def test_histogram_shape_and_outlier_bins(gaussian_values):
    h = build_histogram(gaussian_values, num_bins=10000)
    assert h.num_bins == 10000
    assert h.counts.sum() == len(gaussian_values)
    # outer catch-all bins reach the true extremes
    assert h.edges[0] == gaussian_values.min()
    assert h.edges[-1] == gaussian_values.max()
    # interior is uniform between ~1%/99% order statistics
    widths = np.diff(h.edges[1:-1])
    assert np.allclose(widths, widths[0], rtol=1e-3)


def test_streaming_accumulation_matches_batch(gaussian_values):
    import jax.numpy as jnp

    h = build_histogram(gaussian_values)
    edges = jnp.asarray(h.edges)
    counts = jnp.zeros(h.num_bins)
    for chunk in np.array_split(gaussian_values, 4):
        counts = accumulate_counts(edges, jnp.asarray(chunk), counts)
    # np.histogram uses [lo, hi) except the last bin [lo, hi]; the streaming
    # path clips into the outer bins — totals and quantiles must agree.
    assert float(counts.sum()) == len(gaussian_values)
    d1 = Distribution.from_counts(np.asarray(counts), h.centers)
    d2 = Distribution(h)
    assert d1.icdf(0.75) == pytest.approx(d2.icdf(0.75), rel=1e-3)


def test_abs_icdf_gaussian(gaussian_values):
    d = Distribution.from_values(gaussian_values)
    # |X| for X~N(0,2): P(|X|<=t)=q  =>  t = 2*norm.ppf((1+q)/2)
    for q in [0.5, 0.8]:
        expected = 2.0 * stats.norm.ppf((1 + q) / 2)
        assert d.abs_icdf(q) == pytest.approx(expected, rel=0.02)
    # equivalence with the signed rule for symmetric distributions
    assert d.abs_icdf(0.5) == pytest.approx(d.icdf(0.75), rel=0.02)


def test_pdf_integrates_to_one(gaussian_values):
    d = Distribution.from_values(gaussian_values[:200_000])
    xs = np.linspace(-8, 8, 801)
    pdf = d.pdf(xs)
    assert np.trapezoid(pdf, xs) == pytest.approx(1.0, abs=0.02)


def test_histogram_io_roundtrip(tmp_path, gaussian_values):
    h1 = build_histogram(gaussian_values[:100_000])
    h2 = build_histogram(gaussian_values[100_000:200_000])
    save_histograms(str(tmp_path), {"h1": h1, "h2": h2})
    loaded = load_histograms(str(tmp_path))
    assert set(loaded) == {"h1", "h2"}
    np.testing.assert_allclose(loaded["h1"].counts, h1.counts)
    np.testing.assert_allclose(
        loaded["h2"].centers, h2.centers.astype(np.float32)
    )


def test_load_reference_pt_format(tmp_path):
    """Compatibility with TEAL's shipped histograms.pt artifacts."""
    torch = pytest.importorskip("torch")
    h = build_histogram(np.random.default_rng(3).normal(size=50_000))
    torch.save(
        {
            "h1": torch.tensor(h.counts, dtype=torch.float32),
            "h1_centers": torch.tensor(h.centers, dtype=torch.float32),
        },
        tmp_path / "histograms.pt",
    )
    loaded = load_histograms(str(tmp_path))
    d1 = Distribution(loaded["h1"])
    d2 = Distribution(h)
    assert d1.icdf(0.75) == pytest.approx(d2.icdf(0.75), rel=1e-4)
