"""Prefill + decode generation engine.

Equivalent surface to the reference's generation loop
(`gpt-fast/generate.py:68-217`) rebuilt for XLA's compilation model:

  - `prefill`: one jitted forward over the (padded) prompt.
  - `decode_step`: one jitted single-token step with the KV cache donated,
    so XLA reuses the cache buffer in place (the JAX answer to the
    reference's CUDA-graph `decode_one_token`, generate.py:420).
  - `decode_scan`: N decode steps fused into one jitted `lax.scan` — an
    on-device generation loop with zero per-token host dispatch, used for
    benchmarking (and strictly stronger than CUDA-graph replay: the whole
    token loop is one XLA program).

Throughput accounting mirrors the reference protocol
(`gpt-fast/generate.py:493-506`): tokens/s over the decode loop, achieved
bandwidth = non-embedding parameter bytes x tokens/s.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.engine import sampling
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


def _pad_len(n: int) -> int:
    """Next power of two (min 8): prompt padding to bound prefill retraces."""
    p = 8
    while p < n:
        p *= 2
    return p


@dataclass
class GenerateStats:
    prefill_s: float
    decode_s: float
    new_tokens: int
    tokens_per_s: float
    bandwidth_gb_s: float


class Generator:
    """Owns jitted entry points for one (model config, sparsity config)."""

    def __init__(self, cfg: ModelConfig, params, *,
                 sp: SparsityConfig = SparsityConfig(),
                 max_seq: Optional[int] = None, batch: int = 1,
                 cache_dtype=jnp.bfloat16,
                 temperature: float = 0.8, top_k: Optional[int] = 200):
        self.cfg = cfg
        self.params = params
        self.sp = sp
        self.max_seq = max_seq or cfg.max_seq_len
        self.batch = batch
        self.cache_dtype = cache_dtype
        self.temperature = temperature
        self.top_k = top_k
        def leaf_bytes(w):
            if isinstance(w, dict):
                return sum(a.size * a.dtype.itemsize for a in w.values())
            return w.size * w.dtype.itemsize

        # actual projection bytes (handles bf16/int8/packed-int4 leaves);
        # reference protocol excludes embeddings (generate.py:336-346)
        self.model_bytes = sum(
            leaf_bytes(params["layers"][n])
            for n in ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown",
                      "router")
            if n in params["layers"]
        )

        fwd = functools.partial(llama.forward, cfg=cfg, sp=sp)
        dense_sp = sp.replace(enabled=False)
        fwd_dense_prefill = functools.partial(
            llama.forward, cfg=cfg,
            sp=sp if sp.apply_prefill else dense_sp,
            causal_prefill=True,   # prefill always starts at pos 0
        )

        def prefill_fn(params, cache, tokens, pos, thresholds, key, true_len):
            logits, cache = fwd_dense_prefill(
                params, tokens, cache, pos, thresholds
            )
            last = logits[:, true_len - 1, :]
            tok = sampling.sample(key, last, temperature, top_k)
            return tok, cache

        def decode_fn(params, cache, token, pos, thresholds, key):
            logits, cache = fwd(params, token[:, None], cache, pos, thresholds)
            tok = sampling.sample(key, logits[:, 0, :], temperature, top_k)
            return tok, cache

        def decode_scan_fn(params, cache, token, pos, thresholds, key, n):
            def body(carry, _):
                token, cache, pos, key = carry
                key, sub = jax.random.split(key)
                tok, cache = decode_fn(params, cache, token, pos, thresholds, sub)
                return (tok, cache, pos + 1, key), tok

            (_, cache, _, _), toks = jax.lax.scan(
                body, (token, cache, pos, key), None, length=n
            )
            return toks, cache

        # donate the cache so decode updates it in place
        self._prefill = jax.jit(prefill_fn, donate_argnums=(1,),
                                static_argnums=(6,))
        self._decode = jax.jit(decode_fn, donate_argnums=(1,))
        self._decode_scan = jax.jit(decode_scan_fn, donate_argnums=(1,),
                                    static_argnums=(6,))

    def new_cache(self) -> KVCache:
        return KVCache.init(self.cfg, self.batch, self.max_seq,
                            self.cache_dtype)

    def warmup(self, prompt_len: int = 4, new_tokens: int = 2) -> None:
        """Compile + execute the prefill/decode programs once so later
        `generate` timings are warm (the reference times 5 samples after a
        warm-up sample, gpt-fast/generate.py:431-497)."""
        prompt = np.ones((self.batch, prompt_len), np.int64)
        self.generate(prompt, new_tokens)

    def generate(self, prompt_tokens, max_new_tokens: int, *,
                 thresholds=None, key=None, on_device_loop: bool = True
                 ) -> Tuple[np.ndarray, GenerateStats]:
        """prompt_tokens: [B, T] or [T] ints. Returns (all tokens, stats)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        if thresholds is None:
            thresholds = llama.zero_thresholds(self.cfg)
        prompt = jnp.asarray(prompt_tokens, jnp.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        b, t = prompt.shape
        assert b == self.batch, (b, self.batch)

        padded = jnp.zeros((b, _pad_len(t)), jnp.int32).at[:, :t].set(prompt)
        cache = self.new_cache()

        key, kp = jax.random.split(key)
        t0 = time.perf_counter()
        tok, cache = self._prefill(self.params, cache, padded, 0,
                                   thresholds, kp, t)
        tok = jax.block_until_ready(tok)
        t1 = time.perf_counter()

        if on_device_loop:
            toks, cache = self._decode_scan(
                self.params, cache, tok, t, thresholds, key,
                max_new_tokens - 1,
            )
            toks = np.asarray(toks)                 # [n, B]
            out = np.concatenate(
                [np.asarray(tok)[None], np.asarray(toks)], axis=0
            ).T                                     # [B, new]
        else:
            toks = [np.asarray(tok)]
            pos = t
            for _ in range(max_new_tokens - 1):
                key, sub = jax.random.split(key)
                tok, cache = self._decode(self.params, cache, tok, pos,
                                          thresholds, sub)
                toks.append(np.asarray(tok))
                pos += 1
            out = np.stack(toks, axis=1)
        t2 = time.perf_counter()

        decode_s = t2 - t1
        n_new = out.shape[1]
        tps = (n_new - 1) / decode_s if decode_s > 0 else float("inf")
        stats = GenerateStats(
            prefill_s=t1 - t0,
            decode_s=decode_s,
            new_tokens=n_new,
            tokens_per_s=tps,
            bandwidth_gb_s=self.model_bytes * tps / 1e9,
        )
        all_tokens = np.concatenate([np.asarray(prompt), out], axis=1)
        return all_tokens, stats
