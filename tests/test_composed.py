"""Composed-mesh parallelism: dp×pp×tp decode/prefill, sp×tp prefill,
and the SP-prefill → TP-decode handoff on one cache (VERDICT r2 #5).

The reference has exactly one parallelism axis (NCCL TP,
`gpt-fast/tp.py:54-156`); these tests validate that this framework's
axes compose on a single multi-axis `jax.sharding.Mesh` — pipeline and
sequence parallelism run manual-`shard_map` over their own axis while
GSPMD partitions the tensor-parallel projections inside the body
(`axis_names={"pp"|"sp"}` partial manualization).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.parallel import (make_pp_mesh, make_sp_mesh, pp_forward,
                               pp_shard_cache, pp_shard_params, shard_cache,
                               shard_params, sp_prefill)


def _cfg(n_layers=4):
    return get_model_config(
        "tiny", n_layers=n_layers, n_heads=8, n_kv_heads=4, dim=256,
        intermediate_size=512, vocab_size=512,
    )


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _reference(cfg, params, toks, max_seq=16):
    th = llama.zero_thresholds(cfg)
    logits, cache = jax.jit(
        lambda p, c, t: llama.forward(p, toks, c, 0, t, cfg=cfg,
                                      sp=SparsityConfig())
    )(params, KVCache.init(cfg, toks.shape[0], max_seq, jnp.float32), th)
    return logits, cache


def test_dp_pp_tp_composed_matches_single_device():
    cfg = _cfg()
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    toks = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None], (4, 1))
    ref_logits, ref_cache = _reference(cfg, params, toks)

    mesh = make_pp_mesh(2, dp=2, tp=2)
    assert mesh.axis_names == ("dp", "pp", "tp")
    pparams = pp_shard_params(params, mesh, cfg)
    pcache = pp_shard_cache(KVCache.init(cfg, 4, 16, jnp.float32), mesh)
    th = llama.zero_thresholds(cfg)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(
            lambda p, c, t: pp_forward(p, toks, c, 0, t, cfg=cfg,
                                       sp=SparsityConfig(), mesh=mesh,
                                       n_micro=2)
        )(pparams, pcache, th)
    assert _rel(logits, ref_logits) < 1e-5
    assert _rel(cache.k, ref_cache.k) < 1e-5
    # weights really landed tp-sharded inside the pp slabs
    assert tuple(pparams["layers"]["wq"].sharding.spec) == (
        "pp", None, "tp")
    assert tuple(cache.k.sharding.spec)[:3] == ("pp", "dp", "tp")


def test_sp_tp_composed_prefill_matches_single_device():
    cfg = _cfg(n_layers=2)
    params = llama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    toks = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None], (2, 1))
    ref_logits, ref_cache = _reference(cfg, params, toks)

    mesh = make_sp_mesh(4, tp=2)
    assert mesh.axis_names == ("sp", "tp")
    tparams = shard_params(params, mesh, cfg)
    th = llama.zero_thresholds(cfg)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(
            lambda p, c, t: sp_prefill(p, toks, c, 0, t, cfg=cfg,
                                       sp=SparsityConfig(), mesh=mesh)
        )(tparams, KVCache.init(cfg, 2, 16, jnp.float32), th)
    assert _rel(logits, ref_logits) < 1e-5
    assert _rel(cache.k, ref_cache.k) < 1e-5
    # prefill hands back a TP-ready cache: heads sharded over tp,
    # replicated over sp
    spec = tuple(cache.k.sharding.spec)
    assert "tp" in spec and "sp" not in spec


def test_sp_prefill_then_tp_decode_handoff():
    """Prefill sequence-parallel, then decode tensor-parallel on the SAME
    mesh and cache — no host round-trip, no resharding pass."""
    cfg = _cfg(n_layers=2)
    params = llama.init_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    toks = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None], (2, 1))
    th = llama.zero_thresholds(cfg)

    # single-device reference: prefill 8 tokens then decode one
    _, ref_cache = _reference(cfg, params, toks)
    next_tok = jnp.array([[9], [3]], jnp.int32)
    ref_logits, _ = jax.jit(
        lambda p, c, t: llama.forward(p, next_tok, c, 8, t, cfg=cfg,
                                      sp=SparsityConfig())
    )(params, ref_cache, th)

    mesh = make_sp_mesh(4, tp=2)
    tparams = shard_params(params, mesh, cfg)
    with jax.set_mesh(mesh):
        _, cache = jax.jit(
            lambda p, c, t: sp_prefill(p, toks, c, 0, t, cfg=cfg,
                                       sp=SparsityConfig(), mesh=mesh)
        )(tparams, KVCache.init(cfg, 2, 16, jnp.float32), th)
        # decode step rides plain GSPMD TP on the prefill's cache
        logits, _ = jax.jit(
            lambda p, c, t: llama.forward(p, next_tok, c, 8, t, cfg=cfg,
                                          sp=SparsityConfig())
        )(tparams, cache, th)
    assert _rel(logits, ref_logits) < 1e-5


def test_pp_only_mesh_still_works():
    """Regression: the 1-D pp path (no dp/tp axes) is unchanged."""
    cfg = _cfg()
    params = llama.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    toks = jnp.tile(jnp.arange(4, dtype=jnp.int32)[None], (4, 1))
    ref_logits, _ = _reference(cfg, params, toks)

    mesh = make_pp_mesh(4)
    assert mesh.axis_names == ("pp",)
    pparams = pp_shard_params(params, mesh, cfg)
    pcache = pp_shard_cache(KVCache.init(cfg, 4, 16, jnp.float32), mesh)
    logits, _ = jax.jit(
        lambda p, c, t: pp_forward(p, toks, c, 0, t, cfg=cfg,
                                   sp=SparsityConfig(), mesh=mesh,
                                   n_micro=2)
    )(pparams, pcache, llama.zero_thresholds(cfg))
    assert _rel(logits, ref_logits) < 1e-5


def test_dp_pp_tp_sparse_decode_step():
    """Threshold sparsity (XLA mask path) composes with the 3-D mesh:
    sparsify-then-shard == shard-then-sparsify for per-(layer, proj)
    scalar thresholds."""
    cfg = _cfg()
    params = llama.init_params(cfg, jax.random.PRNGKey(4), jnp.float32)
    toks = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None], (4, 1))
    spc = SparsityConfig(enabled=True, apply_prefill=True)
    th = jnp.full((cfg.n_layers, 7), 0.02, jnp.float32)

    ref_logits, _ = jax.jit(
        lambda p, c, t: llama.forward(p, toks, c, 0, t, cfg=cfg, sp=spc)
    )(params, KVCache.init(cfg, 4, 16, jnp.float32), th)

    mesh = make_pp_mesh(2, dp=2, tp=2)
    pparams = pp_shard_params(params, mesh, cfg)
    pcache = pp_shard_cache(KVCache.init(cfg, 4, 16, jnp.float32), mesh)
    with jax.set_mesh(mesh):
        logits, _ = jax.jit(
            lambda p, c, t: pp_forward(p, toks, c, 0, t, cfg=cfg, sp=spc,
                                       mesh=mesh, n_micro=2)
        )(pparams, pcache, th)
    assert _rel(logits, ref_logits) < 1e-5
