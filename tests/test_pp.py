"""Pipeline-parallel correctness on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.parallel.pp import (make_pp_mesh, pp_forward, pp_shard_cache,
                                  pp_shard_params)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny", n_layers=4)
    params = llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, params


def _ref(cfg, params, tokens, cache, pos=0, sp=SparsityConfig(), th=None):
    th = llama.zero_thresholds(cfg) if th is None else th
    return llama.forward(params, tokens, cache, pos, th, cfg=cfg, sp=sp)


@pytest.mark.parametrize("stages,n_micro", [(2, 2), (4, 1), (4, 4)])
def test_pp_prefill_matches_single_device(tiny, stages, n_micro):
    cfg, params = tiny
    b = max(n_micro, 4)
    tokens = (jnp.arange(b * 4, dtype=jnp.int32) % cfg.vocab_size
              ).reshape(b, 4)

    ref, cref = _ref(cfg, params, tokens, KVCache.init(cfg, b, 8, jnp.float32))

    mesh = make_pp_mesh(stages)
    p_sh = pp_shard_params(params, mesh, cfg)
    c_sh = pp_shard_cache(KVCache.init(cfg, b, 8, jnp.float32), mesh)
    th = llama.zero_thresholds(cfg)
    out, cout = jax.jit(
        lambda p, c, t: pp_forward(
            p, tokens, c, 0, t, cfg=cfg, sp=SparsityConfig(), mesh=mesh,
            n_micro=n_micro)
    )(p_sh, c_sh, th)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cref.k), np.asarray(cout.k),
                               rtol=1e-5, atol=1e-5)


def test_pp_decode_step_with_sparsity(tiny):
    """One decode token at per-sequence positions, elementwise sparsity."""
    cfg, params = tiny
    b = 4
    sp = SparsityConfig(enabled=True)
    th = jnp.full((cfg.n_layers, 7), 0.05, jnp.float32)
    tokens = jnp.array([[3], [7], [1], [9]], jnp.int32)
    pos = jnp.array([2, 5, 0, 3], jnp.int32)

    key = jax.random.PRNGKey(1)
    k0 = jax.random.normal(key, (cfg.n_layers, b, cfg.n_kv_heads, 8,
                                 cfg.head_dim), jnp.float32)
    cache = KVCache(k=k0, v=k0 * 0.3)
    ref, cref = _ref(cfg, params, tokens, cache, pos=pos, sp=sp, th=th)

    mesh = make_pp_mesh(2)
    p_sh = pp_shard_params(params, mesh, cfg)
    c_sh = pp_shard_cache(KVCache(k=k0, v=k0 * 0.3), mesh)
    out, cout = jax.jit(
        lambda p, c, t: pp_forward(p, tokens, c, pos, t, cfg=cfg, sp=sp,
                                   mesh=mesh, n_micro=2)
    )(p_sh, c_sh, th)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cref.v), np.asarray(cout.v),
                               rtol=1e-5, atol=1e-5)


def test_pp_rejects_indivisible_layers(tiny):
    cfg, params = tiny
    mesh = make_pp_mesh(3, devices=jax.devices()[:3])
    with pytest.raises(ValueError, match="not divisible"):
        pp_shard_params(params, mesh, cfg)


def test_pp_quantized_lm_head(tiny):
    """Quantized checkpoints (dict lm_head) shard and run through pp:
    spec trees mirror the param subtree and the last stage uses the
    format-aware lm head."""
    from teal_jax.ops.quant import quantize_int8

    cfg, params = tiny
    q = quantize_int8(params["lm_head"])
    qparams = dict(params, lm_head={"q": q.q, "scale": q.scale})
    mesh = make_pp_mesh(2)
    sharded = pp_shard_params(qparams, mesh, cfg)
    tokens = jnp.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], jnp.int32)
    cache = KVCache.init(cfg, 2, 16, jnp.float32)
    ref, _ = _ref(cfg, qparams, tokens, cache)
    got, _ = pp_forward(sharded, tokens, pp_shard_cache(cache, mesh), 0,
                        llama.zero_thresholds(cfg), cfg=cfg,
                        sp=SparsityConfig(), mesh=mesh, n_micro=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
