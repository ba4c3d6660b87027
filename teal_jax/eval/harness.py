"""lm-evaluation-harness adapter (capability parity with
`gpt-fast/eval.py:85-151`).

Wraps the teal_jax model as an `lm_eval` model so downstream tasks
(hellaswag etc.) run against dense or sparse configurations. The real
`lm_eval` package is preferred when installed; otherwise the vendored
API shim (`teal_jax.eval.lm_eval_shim`) provides the same LM interface
and a small evaluator, so tasks run end-to-end either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


class ScoreModel:
    """Minimal scoring interface: total log-likelihood of a continuation
    given a context (the primitive lm-eval tasks are built on)."""

    def __init__(self, params, cfg: ModelConfig, *,
                 sp: SparsityConfig = SparsityConfig(), thresholds=None,
                 max_seq: int = 2048):
        self.params = params
        self.cfg = cfg
        self.sp = sp
        self.thresholds = (thresholds if thresholds is not None
                           else llama.zero_thresholds(cfg))
        self.max_seq = max_seq
        self._logp = None

    def _token_logprobs(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(log P(ids[i] | ids[:i]), argmax token at each position) for
        i >= 1. ids: [T]. The argmax ids feed the `is_greedy` flag
        (continuation == greedy decode), computed from the same logits
        rather than re-running generation (reference compares against
        greedy continuations the same way through lm_eval's HFLM)."""
        import functools

        if self._logp is None:
            @functools.partial(jax.jit, static_argnames=())
            def f(params, tokens, n_valid, thresholds):
                t = tokens.shape[1]
                cache = KVCache.init(self.cfg, 1, t,
                                     llama.compute_dtype(params))
                logits, _ = llama.forward(
                    params, tokens, cache, 0, thresholds,
                    cfg=self.cfg, sp=self.sp, causal_prefill=True,
                )
                logits = logits[:, :-1].astype(jnp.float32)
                logp = jax.nn.log_softmax(logits, axis=-1)
                lp = jnp.take_along_axis(
                    logp, tokens[:, 1:, None], axis=-1
                )[0, :, 0]
                greedy = jnp.argmax(logits, axis=-1)[0]
                pos = jnp.arange(1, t)
                return jnp.where(pos < n_valid, lp, 0.0), greedy

            self._logp = f

        t = len(ids)
        pad = 1 << max(3, (t - 1).bit_length())   # pad to power of two
        pad = min(pad, self.max_seq)
        if t > pad:
            ids = ids[-pad:]
            t = pad
        padded = np.zeros(pad, np.int64)
        padded[:t] = ids
        lp, greedy = self._logp(
            self.params, jnp.asarray(padded[None], jnp.int32),
            jnp.asarray(t), self.thresholds,
        )
        return np.asarray(lp)[: t - 1], np.asarray(greedy)[: t - 1]

    def loglikelihood(self, context_ids: Sequence[int],
                      continuation_ids: Sequence[int]) -> Tuple[float, bool]:
        """(sum logprob of continuation, is_greedy). is_greedy is true iff
        every continuation token is the argmax prediction at its position
        (exact greedy-match, per lm_eval semantics — not a probability
        proxy)."""
        ids = np.asarray(list(context_ids) + list(continuation_ids))
        n_ctx = len(context_ids)
        if len(ids) > self.max_seq:
            # lm_eval convention: truncate CONTEXT from the left, keep
            # the whole continuation (plus >= 1 conditioning token) —
            # _token_logprobs' own tail-truncation would otherwise
            # desync the n_ctx indexing below
            drop = len(ids) - self.max_seq
            if drop >= n_ctx:
                raise ValueError(
                    f"continuation ({len(continuation_ids)} tokens) "
                    f"does not fit max_seq={self.max_seq} with at least "
                    "one context token")
            ids = ids[drop:]
            n_ctx -= drop
        lp, greedy = self._token_logprobs(ids)
        cont_lp = lp[n_ctx - 1:]
        cont_pred = greedy[n_ctx - 1:]
        cont_true = ids[n_ctx:]
        is_greedy = bool(np.all(cont_pred == cont_true))
        return float(cont_lp.sum()), is_greedy

    def score_choices(self, context_ids: Sequence[int],
                      choices: Sequence[Sequence[int]]) -> int:
        """Index of the highest-likelihood continuation (multiple choice)."""
        scores = [self.loglikelihood(context_ids, c)[0] for c in choices]
        return int(np.argmax(scores))


def _lm_base():
    """The LM base class: real lm_eval when installed, vendored shim
    otherwise (identical calling convention)."""
    try:
        from lm_eval.api.model import LM  # type: ignore
        return LM, True
    except ImportError:
        from teal_jax.eval.lm_eval_shim import LM
        return LM, False


def make_lm_eval_model(score_model: ScoreModel, tokenizer, *,
                       generator=None, max_gen_toks: int = 64):
    """Build an lm_eval-compatible LM over a ScoreModel (+ optional
    `teal_jax.engine.Generator` for generate_until; one is built lazily
    with greedy sampling when omitted)."""
    LM, _is_real = _lm_base()

    def get_generator():
        nonlocal generator
        if generator is None:
            from teal_jax.engine import Generator

            generator = Generator(
                score_model.cfg, score_model.params, sp=score_model.sp,
                max_seq=score_model.max_seq, temperature=0.0, top_k=None,
            )
        return generator

    class TealTPULM(LM):
        def loglikelihood(self, requests):
            out = []
            for req in requests:
                ctx, cont = req.args
                ctx_ids = tokenizer.encode(ctx, bos=True)
                cont_ids = tokenizer.encode(cont)
                out.append(score_model.loglikelihood(ctx_ids, cont_ids))
            return out

        def loglikelihood_rolling(self, requests):
            out = []
            for req in requests:
                (text,) = req.args
                ids = tokenizer.encode(text, bos=True)
                lp, _ = score_model._token_logprobs(np.asarray(ids))
                out.append(float(lp.sum()))
            return out

        def generate_until(self, requests):
            gen = get_generator()
            out = []
            for req in requests:
                ctx, kwargs = req.args
                until = kwargs.get("until", [])
                max_toks = int(kwargs.get("max_gen_toks", max_gen_toks))
                ids = tokenizer.encode(ctx, bos=True)
                tokens, _ = gen.generate(
                    np.asarray(ids), max_toks,
                    thresholds=score_model.thresholds,
                )
                text = tokenizer.decode(tokens[0][len(ids):])
                for stop in until:
                    pos = text.find(stop)
                    if pos >= 0:
                        text = text[:pos]
                out.append(text)
            return out

    return TealTPULM()
