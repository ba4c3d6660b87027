"""int8-quantized Mixtral MoE (reference parity: every published Mixtral
baseline is int8, `gpt-fast/README.md:25-29`; experts quantize per
(layer, expert, out-channel), the router/gate stays fp —
`mixtral-moe/quantize.py:56,73` skips it).  Covers the whole-model
quantizer on 4-D expert stacks, the XLA decode/prefill paths, and GSPMD
TP specs for quantized expert leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.ops.quant import quantize_params_int8


@pytest.fixture(scope="module")
def moe_q8():
    cfg = get_model_config("tiny", n_layers=2, n_heads=2, n_kv_heads=2,
                           dim=256, intermediate_size=384, vocab_size=128,
                           n_experts=4, n_experts_per_tok=2)
    assert cfg.head_dim == 128
    params = llama.init_params(cfg, jax.random.PRNGKey(17), jnp.float32)
    qparams = quantize_params_int8(params)
    return cfg, params, qparams


def test_moe_int8_leaf_shapes(moe_q8):
    cfg, params, qp = moe_q8
    L, E, D, I = (cfg.n_layers, cfg.n_experts, cfg.dim,
                  cfg.intermediate_size)
    lay = qp["layers"]
    assert lay["wgate"]["q"].shape == (L, E, D, I)
    assert lay["wgate"]["q"].dtype == jnp.int8
    assert lay["wgate"]["scale"].shape == (L, E, I)
    assert lay["wdown"]["scale"].shape == (L, E, D)
    # router stays fp (reference skips the gate)
    assert not isinstance(lay["router"], dict)
    assert lay["wq"]["q"].shape == (L, D, D)


def test_moe_int8_dequant_roundtrip(moe_q8):
    """Per-(layer, expert, out-channel) symmetric int8: dequantized
    expert weights reconstruct the originals to the int8 grid."""
    cfg, params, qp = moe_q8
    q = np.asarray(qp["layers"]["wgate"]["q"], np.float32)
    s = np.asarray(qp["layers"]["wgate"]["scale"], np.float32)
    w = np.asarray(params["layers"]["wgate"], np.float32)
    deq = q * s[:, :, None, :]
    step = s[:, :, None, :]
    assert np.abs(deq - w).max() <= (0.5 * step + 1e-7).max()


def test_moe_int8_decode_matches_dequant(moe_q8):
    """int8 XLA decode (expert gather + dequant-in-matmul) == the same
    weights dequantized up front, within bf16 compute tolerance."""
    cfg, params, qp = moe_q8
    from teal_jax.ops.quant import dequantize_int8, Int8Weight

    deq = {k: v for k, v in params.items() if k != "layers"}
    lay = {}
    for n, leaf in qp["layers"].items():
        if isinstance(leaf, dict):
            q, s = leaf["q"], leaf["scale"]
            w = q.astype(jnp.float32) * s[..., None, :]
            lay[n] = w.astype(jnp.float32)
        else:
            lay[n] = leaf
    deq["layers"] = lay
    deq["lm_head"] = dequantize_int8(
        Int8Weight(qp["lm_head"]["q"], qp["lm_head"]["scale"]), jnp.float32)

    th = llama.zero_thresholds(cfg)
    sp = SparsityConfig()
    tok = jnp.asarray([[5]], jnp.int32)
    cache_q = KVCache.init(cfg, 1, 8, jnp.bfloat16)
    cache_d = KVCache.init(cfg, 1, 8, jnp.bfloat16)
    got, _ = llama.forward(qp, tok, cache_q, 0, th, cfg=cfg, sp=sp)
    # dequantized params are fp32 -> fp32 compute; quantized path runs
    # bf16 compute, so compare loosely
    ref, _ = llama.forward(deq, tok, cache_d, 0, th, cfg=cfg, sp=sp)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=5e-2, atol=5e-2)


def test_moe_int8_prefill_runs(moe_q8):
    cfg, _, qp = moe_q8
    th = llama.zero_thresholds(cfg)
    tok = jnp.asarray([[3, 9, 4, 1]], jnp.int32)
    cache = KVCache.init(cfg, 1, 8, jnp.bfloat16)
    logits, _ = llama.forward(qp, tok, cache, 0, th, cfg=cfg,
                              sp=SparsityConfig())
    assert np.isfinite(np.asarray(logits)).all()


def test_moe_int8_tp_matches_single_device(moe_q8):
    """GSPMD TP with QUANTIZED expert leaves: {"q","scale"} dicts shard
    per-field ({q: colwise/rowwise, scale: out-channel}); logits match
    the unsharded int8 model."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    from teal_jax.parallel import make_mesh, shard_cache, shard_params

    cfg, _, qp = moe_q8
    tokens = jnp.array([[5, 3, 8, 1]], jnp.int32)
    th = llama.zero_thresholds(cfg)

    cache = KVCache.init(cfg, 1, 8, jnp.bfloat16)
    ref, _ = llama.forward(qp, tokens, cache, 0, th, cfg=cfg,
                           sp=SparsityConfig())

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    p_sh = shard_params(qp, mesh, cfg)
    c_sh = shard_cache(KVCache.init(cfg, 1, 8, jnp.bfloat16), mesh)
    with jax.set_mesh(mesh):
        out, _ = jax.jit(
            lambda p, c: llama.forward(p, tokens, c, 0, th, cfg=cfg,
                                       sp=SparsityConfig())
        )(p_sh, c_sh)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=2e-2, atol=2e-2)


def test_moe_int8_generation(moe_q8):
    from teal_jax.engine.generate import Generator

    cfg, _, qp = moe_q8
    gen = Generator(cfg, qp, max_seq=32, temperature=0.0)
    out, _ = gen.generate(np.array([1, 2, 3]), 6)
    assert out.shape == (1, 9)
    assert np.all(out < cfg.vocab_size)
