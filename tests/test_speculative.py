"""Speculative decoding: self-draft exactness, acceptance accounting."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import get_model_config
from teal_jax.engine.speculative import speculative_generate
from teal_jax.engine.generate import Generator
from teal_jax.models import llama


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return cfg, params


def test_self_draft_accepts_everything(tiny):
    """draft == target => q/p == 1 => every draft token accepted."""
    cfg, params = tiny
    prompt = [1, 2, 3]
    toks, stats = speculative_generate(
        params, params, cfg, cfg, prompt, 12,
        speculate_k=4, temperature=0.0, max_seq=64,
        cache_dtype=jnp.float32, key=jax.random.PRNGKey(3),
    )
    assert stats["mean_accepted"] == 4.0
    assert stats["new_tokens"] >= 12


def test_self_draft_matches_greedy_decode(tiny):
    """With temperature ~0 and draft == target, speculative output must
    equal plain greedy decoding."""
    cfg, params = tiny
    prompt = np.array([5, 2, 7])
    gen = Generator(cfg, params, max_seq=64, temperature=0.0)
    ref, _ = gen.generate(prompt, 10)

    toks, _ = speculative_generate(
        params, params, cfg, cfg, prompt, 10,
        speculate_k=3, temperature=0.0, max_seq=64,
        cache_dtype=jnp.float32, key=jax.random.PRNGKey(9),
    )
    np.testing.assert_array_equal(ref[0][:3 + 10], toks[: 3 + 10])


def test_different_draft_partial_acceptance(tiny):
    cfg, params = tiny
    draft_params = llama.init_params(cfg, jax.random.PRNGKey(42), jnp.float32)
    toks, stats = speculative_generate(
        params, draft_params, cfg, cfg, [1, 2, 3], 16,
        speculate_k=4, temperature=1.0, top_k=50, max_seq=64,
        cache_dtype=jnp.float32, key=jax.random.PRNGKey(0),
    )
    assert 0.0 <= stats["mean_accepted"] <= 4.0
    assert stats["new_tokens"] >= 16
    assert np.all(toks >= 0) and np.all(toks < cfg.vocab_size)


def test_device_loop_matches_host_loop(tiny):
    """The on-device while_loop program must produce exactly the host
    loop's tokens (same RNG key stream, same acceptance decisions)."""
    cfg, params = tiny
    draft_params = llama.init_params(cfg, jax.random.PRNGKey(7),
                                     jnp.float32)
    kw = dict(speculate_k=3, temperature=1.0, top_k=20, max_seq=64,
              cache_dtype=jnp.float32)
    host, hstats = speculative_generate(
        params, draft_params, cfg, cfg, [4, 8, 2], 14,
        key=jax.random.PRNGKey(11), **kw)
    dev, dstats = speculative_generate(
        params, draft_params, cfg, cfg, [4, 8, 2], 14,
        key=jax.random.PRNGKey(11), device_loop=True, **kw)
    np.testing.assert_array_equal(host[:len(dev)], dev)
    assert dstats["rounds"] >= 1


def test_self_speculative_lossless_greedy(tiny):
    """Self-speculation: a SPARSE draft of the same weights + dense
    verify must reproduce the dense model's greedy output exactly —
    sparsity as a lossless speedup, whatever the draft's quality."""
    cfg, params = tiny
    from teal_jax.config import SparsityConfig

    prompt = np.array([3, 1, 4])
    gen = Generator(cfg, params, max_seq=64, temperature=0.0)
    ref, _ = gen.generate(prompt, 12)

    # aggressively sparse draft (high threshold) — disagreement expected
    draft_sp = SparsityConfig(enabled=True)
    th = jnp.full((cfg.n_layers, 7), 0.08, jnp.float32)
    for device_loop in (False, True):
        toks, stats = speculative_generate(
            params, params, cfg, cfg, prompt, 12,
            speculate_k=4, temperature=0.0, max_seq=64,
            cache_dtype=jnp.float32, draft_sp=draft_sp,
            draft_thresholds=th, key=jax.random.PRNGKey(5),
            device_loop=device_loop,
        )
        np.testing.assert_array_equal(ref[0][:3 + 12], toks[:3 + 12])


def test_shared_vs_separate_cache_both_lossless(tiny):
    """The shared-cache self-speculation design (one KV cache: draft
    writes sparse in-round kv, verify overwrites densely — no top-up
    forward) and the classic two-cache design must BOTH reproduce dense
    greedy output exactly. The designs differ in the draft's history
    conditioning, so accepted counts may differ; the output may not."""
    cfg, params = tiny
    from teal_jax.config import SparsityConfig

    prompt = np.array([2, 9, 4, 1])
    gen = Generator(cfg, params, max_seq=64, temperature=0.0)
    ref, _ = gen.generate(prompt, 12)

    draft_sp = SparsityConfig(enabled=True)
    th = jnp.full((cfg.n_layers, 7), 0.06, jnp.float32)
    for shared_cache in (True, False):
        for device_loop in (False, True):
            toks, _ = speculative_generate(
                params, params, cfg, cfg, prompt, 12,
                speculate_k=4, temperature=0.0, max_seq=64,
                cache_dtype=jnp.float32, draft_sp=draft_sp,
                draft_thresholds=th, key=jax.random.PRNGKey(5),
                device_loop=device_loop, shared_cache=shared_cache,
            )
            np.testing.assert_array_equal(ref[0][:4 + 12], toks[:4 + 12])


def test_shared_cache_requires_shared_params(tiny):
    cfg, params = tiny
    draft_params = llama.init_params(cfg, jax.random.PRNGKey(1),
                                     jnp.float32)
    with pytest.raises(ValueError, match="shared_cache"):
        speculative_generate(
            params, draft_params, cfg, cfg, [1, 2], 4,
            speculate_k=2, max_seq=64, cache_dtype=jnp.float32,
            shared_cache=True,
        )


@pytest.mark.slow
def test_shared_cache_kernel_verify_lossless_greedy():
    """Shared-cache self-speculation with a block-sparse draft through
    the sparse GEMV (interpret mode) and the dense XLA verify reproduces
    dense greedy decoding exactly."""
    from teal_jax.ops.sparse_gemv_gpu import interpret_mode

    from teal_jax.config import SparsityConfig

    cfg = get_model_config(
        "tiny", n_layers=2, n_heads=2, n_kv_heads=2,
        dim=256, intermediate_size=384, vocab_size=128)
    params = llama.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    prompt = np.array([5, 2, 7])
    gen = Generator(cfg, params, max_seq=64, temperature=0.0)
    ref, _ = gen.generate(prompt, 10)

    draft_sp = SparsityConfig(enabled=True, kernel="block",
                              block_size=128, block_keep_frac=0.5,
                              block_thresholding=True)
    th = jnp.zeros((cfg.n_layers, 7), jnp.float32)
    with interpret_mode():
        toks, stats = speculative_generate(
            params, params, cfg, cfg, prompt, 10,
            speculate_k=3, temperature=0.0, max_seq=64,
            cache_dtype=jnp.float32, draft_sp=draft_sp,
            draft_thresholds=th, key=jax.random.PRNGKey(5),
            shared_cache=True,
        )
    np.testing.assert_array_equal(ref[0][:3 + 10], toks[:3 + 10])


def test_device_loop_dynamic_n_target(tiny):
    """The while_loop bound is a traced n_target: one executable serves
    shorter generations (benches sweep lengths without recompiling) and
    the output still matches the full-length prefix under greedy."""
    cfg, params = tiny
    full, _ = speculative_generate(
        params, params, cfg, cfg, [5, 2, 7], 16,
        speculate_k=3, temperature=0.0, max_seq=64,
        cache_dtype=jnp.float32, key=jax.random.PRNGKey(9),
        device_loop=True)
    short, st = speculative_generate(
        params, params, cfg, cfg, [5, 2, 7], 16,
        speculate_k=3, temperature=0.0, max_seq=64,
        cache_dtype=jnp.float32, key=jax.random.PRNGKey(9),
        device_loop=True, n_target=6)
    n = len(short) - 3
    assert 6 <= n - 1 <= 6 + 3 + 1   # bound + up to k+1 overshoot
    np.testing.assert_array_equal(full[:len(short)], short)


def test_two_model_spec_kernel_verify():
    """Two-model speculation (independent tiny draft, head_dim != 128)
    with the TARGET's verify through the XLA forward over k+1 positions
    — the verify must run on cache_t, not the draft cache (an earlier
    verify path passed cache_d unconditionally). The draft decodes
    through the sparse GEMV (interpret mode)."""
    from teal_jax.ops.sparse_gemv_gpu import interpret_mode

    from teal_jax.config import SparsityConfig

    tgt = get_model_config("tiny", n_layers=2, n_heads=2, n_kv_heads=2,
                           dim=256, intermediate_size=384, vocab_size=128)
    dr = get_model_config("tiny", n_layers=2, n_heads=3, n_kv_heads=3,
                          dim=144, intermediate_size=256, vocab_size=128)
    assert dr.head_dim != 128 and tgt.head_dim == 128
    pt = llama.init_params(tgt, jax.random.PRNGKey(0), jnp.float32)
    pd = llama.init_params(dr, jax.random.PRNGKey(1), jnp.float32)
    with interpret_mode():
        toks, st = speculative_generate(
            pt, pd, tgt, dr, [1, 2, 3], 8, speculate_k=3,
            temperature=1.0, max_seq=64, cache_dtype=jnp.float32,
            device_loop=True,
            target_sp=SparsityConfig(enabled=False),
            draft_sp=SparsityConfig(enabled=True, kernel="gather"))
    assert st["new_tokens"] >= 8
    assert np.all(toks >= 0) and np.all(toks < tgt.vocab_size)


def test_speculative_with_sparse_target(tiny):
    """Speculative decoding composes with activation sparsity on the
    target model (masked-dense accuracy path)."""
    from teal_jax.config import SparsityConfig

    cfg, params = tiny
    sp = SparsityConfig(enabled=True, apply_prefill=True)
    th = jnp.full((cfg.n_layers, 7), 0.02, jnp.float32)
    toks, stats = speculative_generate(
        params, params, cfg, cfg, [1, 2, 3], 10,
        speculate_k=3, temperature=0.0, max_seq=64,
        cache_dtype=jnp.float32,
        target_sp=sp, draft_sp=sp,
        target_thresholds=th, draft_thresholds=th,
        key=jax.random.PRNGKey(1),
    )
    # identical (sparse) target and draft still accept everything
    assert stats["mean_accepted"] == 3.0
    assert stats["new_tokens"] >= 10


def test_adaptive_k_lossless_greedy(tiny):
    """Adaptive speculation depth must not change the output: skipped
    draft steps are force-rejected and the zero-padded residual samples
    the target exactly, so greedy output == plain greedy decode at any
    k_eff trajectory the controller takes."""
    cfg, params = tiny
    from teal_jax.config import SparsityConfig

    prompt = np.array([3, 1, 4])
    gen = Generator(cfg, params, max_seq=64, temperature=0.0)
    ref, _ = gen.generate(prompt, 12)

    draft_sp = SparsityConfig(enabled=True)
    th = jnp.full((cfg.n_layers, 7), 0.08, jnp.float32)
    toks, stats = speculative_generate(
        params, params, cfg, cfg, prompt, 12,
        speculate_k=4, temperature=0.0, max_seq=64,
        cache_dtype=jnp.float32, draft_sp=draft_sp,
        draft_thresholds=th, key=jax.random.PRNGKey(5),
        device_loop=True, adaptive_k=True,
    )
    np.testing.assert_array_equal(ref[0][:3 + 12], toks[:3 + 12])
    assert 0 <= stats["k_eff_final"] <= 4
    assert 0.0 <= stats["alpha_hat_final"] <= 1.0


def test_adaptive_k_controller_converges(tiny):
    """forced_alpha harness: at high forced acceptance the controller
    should run deep (k_eff near k), at near-zero acceptance it should
    collapse to the bare-verify regime (k_eff <= 1)."""
    cfg, params = tiny
    from teal_jax.config import SparsityConfig

    draft_sp = SparsityConfig(enabled=True)
    th = jnp.full((cfg.n_layers, 7), 0.08, jnp.float32)
    kw = dict(speculate_k=6, temperature=1.0, max_seq=256,
              cache_dtype=jnp.float32, draft_sp=draft_sp,
              draft_thresholds=th, device_loop=True, adaptive_k=True,
              key=jax.random.PRNGKey(2))
    _, hi = speculative_generate(
        params, params, cfg, cfg, [1, 2, 3], 120,
        forced_alpha=0.97, **kw)
    _, lo = speculative_generate(
        params, params, cfg, cfg, [1, 2, 3], 60,
        forced_alpha=0.02, **kw)
    assert hi["k_eff_final"] >= 4, hi
    assert lo["k_eff_final"] <= 1, lo
    assert hi["alpha_hat_final"] > 0.8
    assert lo["alpha_hat_final"] < 0.2
    # low-acceptance regime still makes progress (>= 1 token/round)
    assert lo["new_tokens"] >= 60


def test_forced_alpha_acceptance_rate(tiny):
    """The measurement harness must realize the forced acceptance rate
    (mean accepted/k over many rounds ~ alpha at fixed k)."""
    cfg, params = tiny
    from teal_jax.config import SparsityConfig

    draft_sp = SparsityConfig(enabled=True)
    th = jnp.full((cfg.n_layers, 7), 0.08, jnp.float32)
    _, st = speculative_generate(
        params, params, cfg, cfg, [1, 2, 3], 150,
        speculate_k=4, temperature=1.0, max_seq=512,
        cache_dtype=jnp.float32, draft_sp=draft_sp,
        draft_thresholds=th, key=jax.random.PRNGKey(4),
        device_loop=True, forced_alpha=0.7,
    )
    # E[accepted]/round at alpha=.7, k=4 is sum_{i=1..4} .7^i ~= 1.77
    # (truncated geometric); the device-loop stat (n_out - rounds)/rounds
    # is biased low by the end-of-generation cap, so tolerate a wide
    # band — the point is ~alpha-level acceptance, not 1.0 or 0.34
    assert 1.3 <= st["mean_accepted"] <= 2.3, st
