"""Mixtral-style MoE: routing, decode-vs-prefill consistency, generation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.engine.generate import Generator
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


@pytest.fixture(scope="module")
def moe_tiny():
    cfg = get_model_config("tiny", n_experts=4, n_experts_per_tok=2)
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, params


def test_moe_params_shapes(moe_tiny):
    cfg, params = moe_tiny
    L, E, D, I = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.intermediate_size
    assert params["layers"]["router"].shape == (L, D, E)
    assert params["layers"]["wgate"].shape == (L, E, D, I)
    assert params["layers"]["wdown"].shape == (L, E, I, D)


def test_moe_decode_matches_prefill(moe_tiny):
    """The gather-k decode path must agree with the all-experts prefill
    path position by position."""
    cfg, params = moe_tiny
    T = 6
    tokens = (jnp.arange(T, dtype=jnp.int32) * 11 % cfg.vocab_size)[None]
    sp = SparsityConfig()
    th = llama.zero_thresholds(cfg)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    full, _ = llama.forward(params, tokens, cache, 0, th, cfg=cfg, sp=sp)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    steps = []
    for i in range(T):
        lg, cache = llama.forward(params, tokens[:, i : i + 1], cache, i,
                                  th, cfg=cfg, sp=sp)
        steps.append(lg[:, 0])
    steps = jnp.stack(steps, axis=1)
    np.testing.assert_allclose(np.asarray(full), np.asarray(steps),
                               atol=5e-4, rtol=1e-3)


def test_moe_generation(moe_tiny):
    cfg, params = moe_tiny
    gen = Generator(cfg, params, max_seq=32, temperature=0.0)
    out, _ = gen.generate(np.array([1, 2, 3]), 6)
    assert out.shape == (1, 9)
    assert np.all(out < cfg.vocab_size)


def test_mixtral_registry_config():
    cfg = get_model_config("Mixtral-8x7B-v0.1")
    assert cfg.n_experts == 8 and cfg.n_experts_per_tok == 2
    assert cfg.n_kv_heads == 8


def test_moe_routing_uses_different_experts(moe_tiny):
    """Different hidden states should route to different experts (sanity
    that routing isn't constant)."""
    from teal_jax.models import moe

    cfg, params = moe_tiny
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    rng = jax.random.PRNGKey(5)
    ys = jax.random.normal(rng, (8, 1, cfg.dim), jnp.float32)
    idxs = []
    for i in range(8):
        logits = ys[i : i + 1] @ lp["router"]
        idxs.append(tuple(np.asarray(jax.lax.top_k(logits, 2)[1]).ravel()))
    assert len(set(idxs)) > 1


def test_moe_batched_decode_matches_single(moe_tiny):
    """B<=8 decode gathers per-token expert sets; each row must equal the
    corresponding single-request decode (VERDICT missing #4: batched
    decode previously silently read all experts)."""
    cfg, params = moe_tiny
    th = llama.zero_thresholds(cfg)
    sp = SparsityConfig()
    toks = jnp.array([[3], [7], [11], [2]], jnp.int32)

    cache = KVCache.init(cfg, 4, 8, jnp.float32)
    batched, _ = llama.forward(params, toks, cache, 0, th, cfg=cfg, sp=sp)
    for b in range(4):
        cache1 = KVCache.init(cfg, 1, 8, jnp.float32)
        single, _ = llama.forward(params, toks[b:b + 1], cache1, 0, th,
                                  cfg=cfg, sp=sp)
        np.testing.assert_allclose(
            np.asarray(batched[b]), np.asarray(single[0]),
            rtol=1e-4, atol=1e-4, err_msg=f"slot {b}",
        )


def test_moe_tp_matches_single_device(moe_tiny):
    """Mixtral TP: expert stacks shard over the intermediate dim (the
    reference's _apply_tp_moe_ffn pattern); logits must match the
    unsharded model (VERDICT missing #4: shard_params used to throw on
    MoE params)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    from teal_jax.models.llama import KVCache
    from teal_jax.parallel import make_mesh, shard_cache, shard_params

    cfg, params = moe_tiny
    tokens = jnp.array([[5, 3, 8, 1]], jnp.int32)
    th = llama.zero_thresholds(cfg)

    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = llama.forward(params, tokens, cache, 0, th, cfg=cfg,
                           sp=SparsityConfig())

    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    p_sh = shard_params(params, mesh, cfg)
    c_sh = shard_cache(KVCache.init(cfg, 1, 8, jnp.float32), mesh)
    with jax.set_mesh(mesh):
        out, _ = jax.jit(
            lambda p, c: llama.forward(p, tokens, c, 0, th, cfg=cfg,
                                       sp=SparsityConfig())
        )(p_sh, c_sh)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-4, atol=1e-4)


def test_moe_capture_and_calibrate(moe_tiny, tmp_path):
    """MoE capture yields attention h1/h2 + mlp h1; calibrate writes
    histograms, skipping the per-expert mlp h2."""
    import os

    from teal_jax.calibration import calibrate

    cfg, params = moe_tiny
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 32))
    out = str(tmp_path / "moe_calib")
    calibrate(params, cfg, tokens, out, num_bins=128,
              save_layer_inputs=False, group_sizes=(16,))
    attn = os.path.join(out, "histograms", "layer-0", "self_attn")
    mlp = os.path.join(out, "histograms", "layer-0", "mlp")
    import numpy as _np

    attn_keys = set(_np.load(os.path.join(attn, "histograms.npz")).keys())
    mlp_keys = set(_np.load(os.path.join(mlp, "histograms.npz")).keys())
    assert {"h1", "h1_centers", "h2", "h2_centers"} <= attn_keys
    assert "h1" in mlp_keys and "h2" not in mlp_keys


def test_moe_prefill_sparsity_engages(moe_tiny):
    """Round 5: the accuracy path's prefill rule reaches the MoE expert
    FFNs (ppl of a sparse Mixtral is measurable): with apply_prefill,
    group and teal modes must both change the logits vs dense, and with
    apply_prefill=False the prefill must stay exactly dense."""
    cfg, params = moe_tiny
    tokens = jnp.arange(1, 17, dtype=jnp.int32)[None]
    th = jnp.full((cfg.n_layers, 7), 0.05, jnp.float32)

    def run(sp):
        cache = KVCache.init(cfg, 1, 32, jnp.float32)
        lg, _ = llama.forward(params, tokens, cache, 0, th, cfg=cfg,
                              sp=sp, causal_prefill=True)
        return np.asarray(lg)

    dense = run(SparsityConfig(enabled=False))
    for mode in ("group", "teal"):
        on = run(SparsityConfig(enabled=True, mode=mode,
                                apply_prefill=True))
        assert np.abs(on - dense).max() > 1e-5, mode
        # last-half rule: the FIRST half's positions stay dense-exact
        np.testing.assert_allclose(on[:, :8], dense[:, :8],
                                   atol=1e-5, err_msg=mode)
    off = run(SparsityConfig(enabled=True, mode="group",
                             apply_prefill=False))
    np.testing.assert_allclose(off, dense, atol=1e-6)
