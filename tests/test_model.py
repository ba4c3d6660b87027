"""Model correctness: decode-vs-prefill consistency, GQA, sparsity wiring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, params


def _forward(cfg, params, tokens, cache, pos, sp=None, thresholds=None):
    sp = sp or SparsityConfig()
    if thresholds is None:
        thresholds = llama.zero_thresholds(cfg)
    return llama.forward(params, tokens, cache, pos, thresholds,
                         cfg=cfg, sp=sp)


def test_forward_shapes(tiny):
    cfg, params = tiny
    cache = KVCache.init(cfg, 2, 32, jnp.float32)
    tokens = jnp.arange(10, dtype=jnp.int32).reshape(2, 5)
    logits, cache2 = _forward(cfg, params, tokens, cache, 0)
    assert logits.shape == (2, 5, cfg.vocab_size)
    assert logits.dtype == jnp.float32
    assert cache2.k.shape == cache.k.shape


def test_decode_matches_prefill(tiny):
    """Token-by-token decode must produce the same logits as one full
    prefill pass — validates cache update, RoPE positions, masking."""
    cfg, params = tiny
    T = 9
    tokens = (jnp.arange(T, dtype=jnp.int32) * 7 % cfg.vocab_size)[None]

    cache = KVCache.init(cfg, 1, 16, jnp.float32)
    full_logits, _ = _forward(cfg, params, tokens, cache, 0)

    cache = KVCache.init(cfg, 1, 16, jnp.float32)
    step_logits = []
    for i in range(T):
        lg, cache = _forward(cfg, params, tokens[:, i : i + 1], cache, i)
        step_logits.append(lg[:, 0])
    step_logits = jnp.stack(step_logits, axis=1)

    np.testing.assert_allclose(
        np.asarray(full_logits), np.asarray(step_logits), atol=2e-4, rtol=1e-3
    )


def test_prefill_in_chunks_matches(tiny):
    cfg, params = tiny
    tokens = (jnp.arange(12, dtype=jnp.int32) * 5 % cfg.vocab_size)[None]
    cache = KVCache.init(cfg, 1, 16, jnp.float32)
    full, _ = _forward(cfg, params, tokens, cache, 0)

    cache = KVCache.init(cfg, 1, 16, jnp.float32)
    _, cache = _forward(cfg, params, tokens[:, :7], cache, 0)
    tail, _ = _forward(cfg, params, tokens[:, 7:], cache, 7)
    np.testing.assert_allclose(
        np.asarray(full[:, 7:]), np.asarray(tail), atol=2e-4, rtol=1e-3
    )


def test_zero_threshold_sparse_equals_dense(tiny):
    """threshold=0 sparsity must be (near-)exactly the dense forward —
    the reference's own degeneracy check (SURVEY §4.2)."""
    cfg, params = tiny
    tokens = jnp.array([[3, 1, 4, 1, 5]], dtype=jnp.int32)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    dense, _ = _forward(cfg, params, tokens, cache, 0)

    sp = SparsityConfig(enabled=True, apply_prefill=True)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    sparse, _ = _forward(cfg, params, tokens, cache, 0, sp=sp)
    np.testing.assert_allclose(np.asarray(dense), np.asarray(sparse),
                               atol=1e-6)


def test_sparsity_changes_output_and_huge_threshold_zeroes_it(tiny):
    cfg, params = tiny
    tokens = jnp.array([[3, 1, 4, 1, 5]], dtype=jnp.int32)
    sp = SparsityConfig(enabled=True, apply_prefill=True)
    th = jnp.full((cfg.n_layers, 7), 1e9, dtype=jnp.float32)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    dense, _ = _forward(cfg, params, tokens, cache, 0)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    allcut, _ = _forward(cfg, params, tokens, cache, 0, sp=sp, thresholds=th)
    # with every projection input zeroed on the sparsified tail, the
    # residual stream passes through untouched on those positions: the
    # logits must differ from dense
    assert not np.allclose(np.asarray(dense), np.asarray(allcut))


def test_per_layer_thresholds_are_independent(tiny):
    """Greedy schedules give different thresholds per layer; check layer 0's
    threshold does not leak into layer 1 (scan indexing)."""
    cfg, params = tiny
    tokens = jnp.array([[2, 7, 2]], dtype=jnp.int32)
    sp = SparsityConfig(enabled=True, apply_prefill=True, prefill_fraction=1.0)

    th_a = jnp.zeros((cfg.n_layers, 7)).at[0].set(0.05)
    th_b = jnp.zeros((cfg.n_layers, 7)).at[1].set(0.05)
    outs = []
    for th in (th_a, th_b):
        cache = KVCache.init(cfg, 1, 8, jnp.float32)
        lg, _ = _forward(cfg, params, tokens, cache, 0, sp=sp, thresholds=th)
        outs.append(np.asarray(lg))
    assert not np.allclose(outs[0], outs[1])


def test_gqa_config():
    cfg = get_model_config("llama-3-8b")
    assert cfg.n_kv_heads == 8 and cfg.n_heads == 32
    assert cfg.head_dim == 128
    assert cfg.proj_shape("k") == (4096, 1024)
    assert cfg.proj_shape("gate") == (4096, 14336)


def test_registry_fuzzy_match():
    cfg = get_model_config("meta-llama/Llama-2-7b-chat-hf")
    assert cfg.name == "7B"
    cfg = get_model_config("mistralai/Mistral-7B-v0.1")
    assert cfg.name == "Mistral-7B"
    assert cfg.sliding_window == 4096
    cfg = get_model_config("Meta-Llama-3-70B")
    assert cfg.name == "llama-3-70b"


def test_sliding_window_masks_old_positions():
    cfg = get_model_config("tiny", sliding_window=4)
    params = llama.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    tokens = (jnp.arange(10, dtype=jnp.int32) % cfg.vocab_size)[None]
    cache = KVCache.init(cfg, 1, 16, jnp.float32)
    lg_w, _ = _forward(cfg, params, tokens, cache, 0)

    cfg2 = get_model_config("tiny")
    cache = KVCache.init(cfg2, 1, 16, jnp.float32)
    lg_full, _ = _forward(cfg2, params, tokens, cache, 0)
    # early positions identical (window not yet binding), late ones differ
    np.testing.assert_allclose(np.asarray(lg_w[:, :4]),
                               np.asarray(lg_full[:, :4]), atol=2e-5)
    assert not np.allclose(np.asarray(lg_w[:, -1]), np.asarray(lg_full[:, -1]))
