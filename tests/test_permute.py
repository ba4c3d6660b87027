"""Channel-permutation clustering: exactness + grouping benefit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.calibration.permute import (
    apply_permutations,
    channel_stats,
    compute_permutations,
    sort_perm,
)
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.ops.sparsify import sparsify_groups


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, params


def test_permuted_model_is_exact(tiny):
    """Folded permutations are a re-parameterization: logits identical."""
    cfg, params = tiny
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    perms = compute_permutations(params, cfg, tokens)
    assert sorted(perms["residual"].tolist()) == list(range(cfg.dim))
    pparams = apply_permutations(params, perms, cfg)

    ids = jnp.asarray(tokens[:, :8], jnp.int32)
    sp = SparsityConfig()
    th = llama.zero_thresholds(cfg)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = llama.forward(params, ids, cache, 0, th, cfg=cfg, sp=sp)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    got, _ = llama.forward(pparams, ids, cache, 0, th, cfg=cfg, sp=sp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_permutation_clusters_hot_channels():
    """Sorting by magnitude makes group sparsity approach unstructured
    quality on heterogeneous channels."""
    rng = np.random.default_rng(0)
    D, G = 256, 16
    # heterogeneous per-channel scales (lognormal, like real LLM channels)
    scales = np.exp(rng.normal(0, 1.5, D))
    x = (rng.normal(size=(64, D)) * scales[None]).astype(np.float32)

    perm = sort_perm(channel_stats(x))
    xp = x[:, perm]

    def group_err(v):
        out = np.asarray(sparsify_groups(jnp.asarray(v), G, 0.5))
        return np.linalg.norm(out - v) / np.linalg.norm(v)

    err_raw = group_err(x)
    err_perm = group_err(xp)
    # unstructured (elementwise top-50%) reference error
    flat_keep = np.abs(x) >= np.quantile(np.abs(x), 0.5, axis=1, keepdims=True)
    err_unstructured = np.linalg.norm(x * (~flat_keep)) / np.linalg.norm(x)
    assert err_perm < err_raw * 0.7, (err_perm, err_raw)
    assert err_perm < err_unstructured * 2.5


def test_permuted_block_decode_runs(tiny):
    """Permuted params drive the sparse GEMV decode path (interpret)."""
    cfg = get_model_config("tiny", dim=256, intermediate_size=512,
                          n_heads=4, n_kv_heads=2, vocab_size=128)
    params = llama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16))
    perms = compute_permutations(params, cfg, tokens)
    pparams = apply_permutations(params, perms, cfg)

    from teal_jax.ops.sparse_gemv_gpu import interpret_mode

    sp = SparsityConfig(enabled=True, kernel="block", block_size=16,
                        block_keep_frac=0.5)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    with interpret_mode():
        lg, _ = llama.forward(pparams, jnp.array([[3]], jnp.int32), cache, 0,
                              llama.zero_thresholds(cfg), cfg=cfg, sp=sp)
    assert np.isfinite(np.asarray(lg)).all()


def test_coactivation_beats_magnitude_on_structured_data():
    """Per-token co-firing structure (latent gates) is invisible to
    magnitude sorting but captured by keep-decision-correlation
    clustering: dropped energy falls well below the magnitude perm's."""
    from teal_jax.calibration.permute import (
        coactivation_perm, group_dropped_energy)

    rng = np.random.default_rng(0)
    P, D, G, n_latent = 1024, 512, 16, 32
    z = rng.integers(0, n_latent, D)
    sigma = np.exp(rng.normal(0, 0.15, D))     # real-h1-like bulk scales

    def draw():
        gates = np.exp(rng.normal(0, 1.2, (P, n_latent)))
        return (gates[:, z] * sigma * rng.normal(size=(P, D))).astype(
            np.float32)

    x_cal, x = draw(), draw()
    p_mag = sort_perm(channel_stats(x_cal))
    p_co = coactivation_perm(x_cal, G, 0.5)
    assert sorted(p_co.tolist()) == list(range(D))
    d_mag = group_dropped_energy(x, p_mag, G, 0.5)
    d_co = group_dropped_energy(x, p_co, G, 0.5)
    assert d_co < 0.6 * d_mag, (d_co, d_mag)


def test_coactivation_graceful_without_structure():
    """On structure-free activations the held-out selection in
    _calibrated_perm falls back to (approximately) magnitude quality."""
    from teal_jax.calibration.permute import (
        _calibrated_perm, group_dropped_energy)

    rng = np.random.default_rng(1)
    P, D, G = 1024, 512, 16
    sigma = np.exp(rng.normal(0, 0.9, D))
    x_cal = (rng.normal(size=(P, D)) * sigma).astype(np.float32)
    x = (rng.normal(size=(P, D)) * sigma).astype(np.float32)
    p_mag = _calibrated_perm(x_cal, G, 0.5, "magnitude")
    p_co = _calibrated_perm(x_cal, G, 0.5, "coactivation")
    d_mag = group_dropped_energy(x, p_mag, G, 0.5)
    d_co = group_dropped_energy(x, p_co, G, 0.5)
    assert d_co < d_mag * 1.35, (d_co, d_mag)


def test_coactivation_model_permutation_exact(tiny):
    """method='coactivation' perms are valid and fold exactly."""
    cfg, params = tiny
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 32))
    perms = compute_permutations(params, cfg, tokens,
                                 method="coactivation", block_size=32)
    assert sorted(perms["residual"].tolist()) == list(range(cfg.dim))
    for q in perms["inter"]:
        assert sorted(q.tolist()) == list(range(cfg.intermediate_size))
    pparams = apply_permutations(params, perms, cfg)

    ids = jnp.asarray(tokens[:, :8], jnp.int32)
    sp = SparsityConfig()
    th = llama.zero_thresholds(cfg)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = llama.forward(params, ids, cache, 0, th, cfg=cfg, sp=sp)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    got, _ = llama.forward(pparams, ids, cache, 0, th, cfg=cfg, sp=sp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
