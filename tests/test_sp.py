"""Sequence-parallel prefill correctness on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.parallel.sp import make_sp_mesh, sp_prefill

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, params


@pytest.mark.parametrize("n_sp", [2, 4])
def test_sp_prefill_matches_single_device(tiny, n_sp):
    cfg, params = tiny
    b, s = 2, 8
    tokens = (jnp.arange(b * s, dtype=jnp.int32) * 3 % cfg.vocab_size
              ).reshape(b, s)

    ref, cref = llama.forward(
        params, tokens, KVCache.init(cfg, b, 16, jnp.float32), 0,
        llama.zero_thresholds(cfg), cfg=cfg, sp=SparsityConfig())

    mesh = make_sp_mesh(n_sp)
    out, cout = jax.jit(
        lambda p, c, t: sp_prefill(p, tokens, c, 0, t, cfg=cfg,
                                   sp=SparsityConfig(), mesh=mesh)
    )(params, KVCache.init(cfg, b, 16, jnp.float32),
      llama.zero_thresholds(cfg))
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cref.k), np.asarray(cout.k),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cref.v), np.asarray(cout.v),
                               rtol=1e-5, atol=1e-5)


def test_sp_prefill_nonzero_base(tiny):
    """Prefill appended at a nonzero base position (continuation)."""
    cfg, params = tiny
    b, s = 1, 4
    tokens = jnp.array([[5, 9, 2, 6]], jnp.int32)
    key = jax.random.PRNGKey(2)
    k0 = jax.random.normal(key, (cfg.n_layers, b, cfg.n_kv_heads, 16,
                                 cfg.head_dim), jnp.float32)
    base = 6

    ref, cref = llama.forward(
        params, tokens, KVCache(k=k0, v=k0 * 0.5), base,
        llama.zero_thresholds(cfg), cfg=cfg, sp=SparsityConfig())

    mesh = make_sp_mesh(2)
    out, cout = jax.jit(
        lambda p, c, t: sp_prefill(p, tokens, c, base, t, cfg=cfg,
                                   sp=SparsityConfig(), mesh=mesh)
    )(params, KVCache(k=k0, v=k0 * 0.5), llama.zero_thresholds(cfg))
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cref.k), np.asarray(cout.k),
                               rtol=1e-5, atol=1e-5)


def test_sp_rejects_indivisible_seq(tiny):
    cfg, params = tiny
    mesh = make_sp_mesh(4)
    with pytest.raises(ValueError, match="not divisible"):
        sp_prefill(params, jnp.ones((1, 6), jnp.int32),
                   KVCache.init(cfg, 1, 16, jnp.float32), 0,
                   llama.zero_thresholds(cfg), cfg=cfg,
                   sp=SparsityConfig(), mesh=mesh)
