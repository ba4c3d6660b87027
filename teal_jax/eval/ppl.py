"""Sliding-window perplexity (the accuracy regression harness).

Windowing parity with the reference (`utils/eval_ppl.py:13-72`):
  - windows of `context_size + window_size` tokens starting every stride,
    sliced from the UNTRUNCATED stream (the reference truncates only the
    loop bound `seq_len` to a stride multiple; trailing windows still
    include the remainder tokens, and the loop breaks once a window's
    unclamped end reaches `seq_len`);
  - NLL computed only on the last `window_size` labels of each window
    (`target_ids[:, :-stride] = -100`; a final window shorter than the
    stride scores all its labels, matching the empty `[:-stride]` slice),
    i.e. each token is scored with at least `context_size` of context;
  - ppl = exp(mean over windows of each window's mean NLL) — windows are
    weighted equally even if the final one is short, as in the reference.

One jitted NLL function serves every window (shorter final windows are
padded and masked), so the whole eval is two compiles (full + final).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


@functools.partial(jax.jit, static_argnames=("cfg", "sp"))
def _window_nll(params, tokens, n_valid, n_score, thresholds,
                cfg: ModelConfig, sp: SparsityConfig):
    """Mean NLL of the last `n_score` valid labels in `tokens` [1, T].

    n_valid: number of real (unpadded) tokens; n_score: labels to score
    (both traced scalars so window geometry doesn't retrace).
    """
    t = tokens.shape[1]
    cache = KVCache.init(cfg, 1, t, llama.compute_dtype(params))
    logits, _ = llama.forward(
        params, tokens, cache, 0, thresholds, cfg=cfg, sp=sp,
        causal_prefill=True,
    )
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    labels = tokens[:, 1:]
    token_logp = jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]

    label_pos = jnp.arange(1, t)[None, :]
    mask = (label_pos < n_valid) & (label_pos >= n_valid - n_score)
    return -jnp.sum(token_logp * mask) / jnp.maximum(jnp.sum(mask), 1)


def eval_ppl(
    params,
    cfg: ModelConfig,
    token_ids,
    *,
    sp: SparsityConfig = SparsityConfig(),
    thresholds=None,
    context_size: int = 2048,
    window_size: int = 512,
    progress: bool = False,
) -> float:
    """Perplexity of a flat token stream under the given sparsity config."""
    if thresholds is None:
        thresholds = llama.zero_thresholds(cfg)
    ids = np.asarray(token_ids).reshape(-1)
    stride = window_size
    max_length = context_size + window_size
    seq_len = len(ids) - (len(ids) % stride)   # loop bound only
    if seq_len < 2:
        raise ValueError(f"token stream too short: {len(ids)}")

    nlls = []
    for begin in range(0, seq_len, stride):
        end = begin + max_length               # unclamped, as in reference
        window = ids[begin:end]                # full-stream slice
        n_valid = len(window)
        padded = np.zeros(max_length, dtype=np.int64)
        padded[:n_valid] = window
        # scored labels: positions with target != -100 after the reference's
        # masking, i.e. the last min(stride, n_valid - 1) labels
        n_score = min(stride, n_valid - 1)
        nll = _window_nll(
            params, jnp.asarray(padded[None], jnp.int32),
            jnp.asarray(n_valid), jnp.asarray(n_score), thresholds,
            cfg, sp,
        )
        nlls.append(float(nll))
        if progress:
            print(f"window {begin}: nll={nlls[-1]:.4f}", flush=True)
        if end >= seq_len:
            break
    return float(np.exp(np.mean(nlls)))
