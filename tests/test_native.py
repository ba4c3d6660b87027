"""Native C++ calibration kernels: build, parity with numpy, speed."""

import time

import numpy as np
import pytest

from teal_jax.native import get_lib
from teal_jax.ops.distribution import (
    Histogram,
    build_histogram,
    make_edges,
)


def numpy_histogram(values, num_bins=1000, outlier_threshold=0.01):
    values = np.asarray(values, np.float32).ravel()
    sv = np.sort(values)
    edges = make_edges(sv, num_bins, outlier_threshold)
    counts = np.histogram(values, bins=edges)[0].astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    return Histogram(counts=counts, centers=centers.astype(np.float32),
                     edges=edges)


def test_native_lib_builds():
    lib = get_lib()
    assert lib is not None, "g++ toolchain present but native build failed"


@pytest.mark.parametrize("n", [1000, 123_457])
@pytest.mark.parametrize("dist", ["normal", "laplace", "lognormal"])
def test_native_matches_numpy_bitwise(n, dist):
    rng = np.random.default_rng(hash((n, dist)) % 2**32)
    vals = getattr(rng, dist)(size=n).astype(np.float32)
    got = build_histogram(vals, num_bins=777)
    want = numpy_histogram(vals, num_bins=777)
    np.testing.assert_array_equal(got.edges, want.edges)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.sum() == n


def test_native_handles_duplicates_and_extremes():
    vals = np.concatenate([
        np.zeros(5000, np.float32),
        np.full(100, 7.25, np.float32),
        np.full(1, -1e30, np.float32),
        np.full(1, 1e30, np.float32),
    ])
    got = build_histogram(vals, num_bins=64)
    want = numpy_histogram(vals, num_bins=64)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_native_is_faster_at_scale():
    if get_lib() is None:
        pytest.skip("no native lib")
    rng = np.random.default_rng(0)
    vals = rng.normal(size=8_000_000).astype(np.float32)
    t0 = time.perf_counter()
    build_histogram(vals, num_bins=10000)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_histogram(vals, num_bins=10000)
    t_numpy = time.perf_counter() - t0
    # don't flake on CI noise: require merely "not slower"
    assert t_native < t_numpy * 1.1, (t_native, t_numpy)
