"""Checkpoint ingest: HF safetensors → params; native save/load roundtrip."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.utils.checkpoint import (
    load_hf_checkpoint,
    load_params,
    save_params,
)


def _write_hf_checkpoint(tmp_path, cfg, seed=0, tied=False, sharded=False):
    """Emit a synthetic HF-format Llama checkpoint (fp32 safetensors)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    t = {}
    D, I, KV, V = cfg.dim, cfg.intermediate_size, cfg.kv_dim, cfg.vocab_size

    def w(shape):
        return rng.normal(0, 0.02, size=shape).astype(np.float32)

    t["model.embed_tokens.weight"] = w((V, D))
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w((D,)) + 1
        t[p + "post_attention_layernorm.weight"] = w((D,)) + 1
        t[p + "self_attn.q_proj.weight"] = w((D, D))
        t[p + "self_attn.k_proj.weight"] = w((KV, D))
        t[p + "self_attn.v_proj.weight"] = w((KV, D))
        t[p + "self_attn.o_proj.weight"] = w((D, D))
        t[p + "mlp.gate_proj.weight"] = w((I, D))
        t[p + "mlp.up_proj.weight"] = w((I, D))
        t[p + "mlp.down_proj.weight"] = w((D, I))
    t["model.norm.weight"] = w((D,)) + 1
    if not tied:
        t["lm_head.weight"] = w((V, D))

    if sharded:
        keys = sorted(t)
        half = len(keys) // 2
        shards = {
            "model-00001-of-00002.safetensors": {k: t[k] for k in keys[:half]},
            "model-00002-of-00002.safetensors": {k: t[k] for k in keys[half:]},
        }
        weight_map = {}
        for fname, tensors in shards.items():
            save_file(tensors, str(tmp_path / fname))
            weight_map.update({k: fname for k in tensors})
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"weight_map": weight_map}, f)
    else:
        save_file(t, str(tmp_path / "model.safetensors"))
    return t


@pytest.fixture(scope="module")
def tiny_cfg():
    return get_model_config("tiny")


def test_hf_load_shapes_and_values(tmp_path, tiny_cfg):
    cfg = tiny_cfg
    t = _write_hf_checkpoint(tmp_path, cfg)
    params = load_hf_checkpoint(str(tmp_path), cfg, dtype=jnp.float32)
    assert params["embed"].shape == (cfg.vocab_size, cfg.dim)
    assert params["layers"]["wq"].shape == (cfg.n_layers, cfg.dim, cfg.dim)
    assert params["layers"]["wk"].shape == (cfg.n_layers, cfg.dim, cfg.kv_dim)
    # projection weights are transposed on load
    np.testing.assert_allclose(
        np.asarray(params["layers"]["wdown"][1]),
        t["model.layers.1.mlp.down_proj.weight"].T,
    )
    np.testing.assert_allclose(
        np.asarray(params["final_norm"]), t["model.norm.weight"]
    )


def test_hf_load_sharded_and_tied(tmp_path, tiny_cfg):
    cfg = tiny_cfg
    _write_hf_checkpoint(tmp_path, cfg, tied=True, sharded=True)
    params = load_hf_checkpoint(str(tmp_path), cfg, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(params["lm_head"]), np.asarray(params["embed"]).T
    )


def test_loaded_model_runs(tmp_path, tiny_cfg):
    cfg = tiny_cfg
    _write_hf_checkpoint(tmp_path, cfg)
    params = load_hf_checkpoint(str(tmp_path), cfg, dtype=jnp.float32)
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    logits, _ = llama.forward(
        params, jnp.array([[1, 2, 3]], jnp.int32), cache, 0,
        llama.zero_thresholds(cfg), cfg=cfg,
        sp=__import__("teal_jax.config", fromlist=["SparsityConfig"]).SparsityConfig(),
    )
    assert logits.shape == (1, 3, cfg.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()


def test_native_roundtrip(tmp_path, tiny_cfg):
    cfg = tiny_cfg
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    save_params(params, str(tmp_path / "native"))
    loaded = load_params(str(tmp_path / "native"))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32))
        )


def test_hf_load_mixtral_moe(tmp_path):
    """Mixtral key scheme: block_sparse_moe.gate + experts.{e}.w1|w2|w3."""
    from safetensors.numpy import save_file
    from teal_jax.config import SparsityConfig

    cfg = get_model_config("tiny", n_experts=2, n_experts_per_tok=2)
    rng = np.random.default_rng(0)
    D, I, KV, V = cfg.dim, cfg.intermediate_size, cfg.kv_dim, cfg.vocab_size

    def w(shape):
        return rng.normal(0, 0.02, size=shape).astype(np.float32)

    t = {"model.embed_tokens.weight": w((V, D)),
         "model.norm.weight": w((D,)) + 1,
         "lm_head.weight": w((V, D))}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w((D,)) + 1
        t[p + "post_attention_layernorm.weight"] = w((D,)) + 1
        for proj, shape in (("q", (D, D)), ("k", (KV, D)), ("v", (KV, D)),
                            ("o", (D, D))):
            t[p + f"self_attn.{proj}_proj.weight"] = w(shape)
        t[p + "block_sparse_moe.gate.weight"] = w((cfg.n_experts, D))
        for e in range(cfg.n_experts):
            q = p + f"block_sparse_moe.experts.{e}."
            t[q + "w1.weight"] = w((I, D))
            t[q + "w2.weight"] = w((D, I))
            t[q + "w3.weight"] = w((I, D))
    save_file(t, str(tmp_path / "model.safetensors"))

    params = load_hf_checkpoint(str(tmp_path), cfg, dtype=jnp.float32)
    assert params["layers"]["router"].shape == (cfg.n_layers, D, cfg.n_experts)
    assert params["layers"]["wgate"].shape == (cfg.n_layers, cfg.n_experts, D, I)
    np.testing.assert_allclose(
        np.asarray(params["layers"]["wdown"][1, 0]),
        t["model.layers.1.block_sparse_moe.experts.0.w2.weight"].T)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    logits, _ = llama.forward(
        params, jnp.array([[1, 2, 3]], jnp.int32), cache, 0,
        llama.zero_thresholds(cfg), cfg=cfg, sp=SparsityConfig())
    assert np.isfinite(np.asarray(logits)).all()
