"""Sliding-window perplexity harness tests (tiny model, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.eval import eval_ppl
from teal_jax.models import llama


@pytest.fixture(scope="module")
def tiny():
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, params


def test_ppl_uniform_model_matches_vocab(tiny):
    """A model with ~uniform logits has ppl ~= vocab_size."""
    cfg, _ = tiny
    # scale weights tiny so logits are near-constant
    params = llama.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    params = jax.tree.map(lambda a: a * 1e-3, params)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 300)
    ppl = eval_ppl(params, cfg, ids, context_size=64, window_size=32)
    assert ppl == pytest.approx(cfg.vocab_size, rel=0.05)


def test_ppl_matches_manual_nll(tiny):
    """Cross-check the windowed harness against a direct full-context NLL
    when the stream fits in a single window."""
    cfg, params = tiny
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, 96)

    ppl = eval_ppl(params, cfg, ids, context_size=48, window_size=16)

    # manual: windows [0:64] scoring last 16, plus [16:64],[32:64],[48:64]
    from teal_jax.models.llama import KVCache

    def manual_window_nll(window, n_score):
        t = len(window)
        cache = KVCache.init(cfg, 1, t, jnp.float32)
        logits, _ = llama.forward(
            params, jnp.asarray(window[None], jnp.int32), cache, 0,
            llama.zero_thresholds(cfg), cfg=cfg, sp=SparsityConfig(),
        )
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        lp = np.asarray(
            jnp.take_along_axis(
                logp, jnp.asarray(window[None, 1:, None]), axis=-1
            )[0, :, 0]
        )
        return -lp[-n_score:].mean()

    # reference windowing (`utils/eval_ppl.py:50-67`): stride 16, window
    # length context+stride = 64, and the loop BREAKS once a window's end
    # reaches the stream end — so begins are 0, 16, 32 only.
    nlls = [
        manual_window_nll(ids[0:64], 16),
        manual_window_nll(ids[16:80], 16),
        manual_window_nll(ids[32:96], 16),
    ]
    assert ppl == pytest.approx(float(np.exp(np.mean(nlls))), rel=1e-4)


def test_sparse_ppl_degrades_gracefully(tiny):
    """ppl(sparse@small) ~ ppl(dense); ppl(sparse@huge) >> ppl(dense)."""
    cfg, params = tiny
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, 200)
    dense = eval_ppl(params, cfg, ids, context_size=64, window_size=32)

    sp = SparsityConfig(enabled=True, apply_prefill=True)
    th_small = jnp.full((cfg.n_layers, 7), 1e-5, jnp.float32)
    near = eval_ppl(params, cfg, ids, sp=sp, thresholds=th_small,
                    context_size=64, window_size=32)
    assert near == pytest.approx(dense, rel=0.02)

    # a huge threshold zeroes every projection input; on a random-weight
    # tiny model dense ppl is already ~vocab_size, so assert the output
    # measurably changed rather than strictly degraded
    th_huge = jnp.full((cfg.n_layers, 7), 1e3, jnp.float32)
    wrecked = eval_ppl(params, cfg, ids, sp=sp, thresholds=th_huge,
                       context_size=64, window_size=32)
    assert wrecked != pytest.approx(dense, rel=1e-3)


def test_stream_truncated_to_stride_multiple(tiny):
    cfg, params = tiny
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, 100)
    # 100 -> truncated to 96 with stride 32; should not crash
    p1 = eval_ppl(params, cfg, ids, context_size=32, window_size=32)
    p2 = eval_ppl(params, cfg, ids[:96], context_size=32, window_size=32)
    assert p1 == pytest.approx(p2, rel=1e-6)
