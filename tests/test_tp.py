"""Tensor-parallel correctness on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.parallel import make_mesh, shard_cache, shard_params

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny")  # n_heads=4, n_kv_heads=2
    params = llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, params


def _forward(cfg, params, tokens, cache, thresholds=None,
             sp=SparsityConfig()):
    if thresholds is None:
        thresholds = llama.zero_thresholds(cfg)
    return llama.forward(params, tokens, cache, 0, thresholds,
                         cfg=cfg, sp=sp)


def test_tp_matches_single_device(tiny):
    cfg, params = tiny
    tokens = jnp.array([[5, 3, 8, 1]], jnp.int32)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = _forward(cfg, params, tokens, cache)

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    p_sh = shard_params(params, mesh, cfg)
    c_sh = shard_cache(KVCache.init(cfg, 1, 8, jnp.float32), mesh)
    with jax.set_mesh(mesh):
        out, _ = jax.jit(
            lambda p, c: _forward(cfg, p, tokens, c)
        )(p_sh, c_sh)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)


def test_tp_decode_with_sparsity(tiny):
    """Per-shard thresholding must equal global thresholding (elementwise
    magnitude criterion is shard-invariant)."""
    cfg, params = tiny
    sp = SparsityConfig(enabled=True, apply_prefill=True,
                        prefill_fraction=1.0)
    th = jnp.full((cfg.n_layers, 7), 0.05, jnp.float32)
    tokens = jnp.array([[5, 3, 8, 1]], jnp.int32)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = _forward(cfg, params, tokens, cache, thresholds=th, sp=sp)

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    p_sh = shard_params(params, mesh, cfg)
    c_sh = shard_cache(KVCache.init(cfg, 1, 8, jnp.float32), mesh)
    with jax.set_mesh(mesh):
        out, _ = jax.jit(
            lambda p, c: _forward(cfg, p, tokens, c, thresholds=th, sp=sp)
        )(p_sh, c_sh)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)


def test_dp_tp_mesh_decode(tiny):
    """2-D mesh (dp=2, tp=2): batch sharded over dp, heads over tp."""
    cfg, params = tiny
    tokens = jnp.array([[5, 3, 8, 1], [2, 9, 4, 7]], jnp.int32)

    cache = KVCache.init(cfg, 2, 8, jnp.float32)
    ref, _ = _forward(cfg, params, tokens, cache)

    mesh = make_mesh(tp=2, dp=2, devices=jax.devices()[:4])
    p_sh = shard_params(params, mesh, cfg)
    c_sh = shard_cache(KVCache.init(cfg, 2, 8, jnp.float32), mesh)
    with jax.set_mesh(mesh):
        out, _ = jax.jit(
            lambda p, c: _forward(cfg, p, tokens, c)
        )(p_sh, c_sh)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)


def test_tp_rejects_indivisible_heads(tiny):
    cfg, params = tiny
    mesh = make_mesh(tp=8, dp=1)
    with pytest.raises(ValueError, match="not divisible"):
        shard_params(params, mesh, cfg)
