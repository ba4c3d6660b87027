"""Speculative decoding (draft proposes k tokens, target verifies in one
forward).

Algorithm parity with the reference (`gpt-fast/generate.py:98-146`):
  - draft decodes `k` tokens sequentially, recording its probs;
  - one target forward over [current, draft_0..k-1] yields k+1 prob rows;
  - draft token i is accepted with prob min(1, q_i/p_i) (q target, p
    draft); on first rejection the replacement token is sampled from the
    residual distribution max(q - p, 0)/sum (:139-146); if all k are
    accepted an extra token is sampled from the target's last row (:131).
  - the draft model's cache is topped up with the last draft token so both
    caches stay aligned (:133-137); rejected positions' cache slots are
    simply overwritten by later steps (attention masks them meanwhile).

The whole step is one jitted program with fixed shapes: it returns a
`[k+1]` token buffer plus `n_valid` (accepted + 1); the host loop advances
by `n_valid`. This keeps XLA happy where the reference relies on dynamic
Python control flow.

`speculative_generate(..., device_loop=True)` goes further than the
reference: the ENTIRE generation loop runs on-device as one
`lax.while_loop` program (accepted tokens written at dynamic offsets into
a fixed buffer), so the host syncs once per generation instead of once
per step — essential when dispatch latency is non-trivial.

Self-speculation (`draft_params is target_params` with a sparse
`draft_sp`): the draft is the SAME weights decoded through the
sparse decode path and the target verifies densely. Speculative
sampling guarantees the output distribution equals dense decoding
exactly — no perplexity delta at any sparsity
(tests/test_speculative.py exactness tests). Its SPEED is bounded by
the draft/target acceptance rate; the adaptive-k controller keeps low
acceptance from costing more than plain decoding.

Shared-cache self-speculation (`shared_cache=True`, the default when
params are shared): draft and target use ONE KV cache. The draft scan
writes its (sparse-forward) kv entries at pos..pos+k-1 into the shared
cache; the dense verify then overwrites pos..pos+k with exact kv.
Consequences, all favorable:
  - the k-th draft top-up forward disappears (the reference tops up the
    separate draft cache, `gpt-fast/generate.py:133-137`; with one cache
    the verify itself leaves every needed slot dense-exact), cutting
    t_round from (k+2) to (k+1) forward passes;
  - cache memory halves (one cache instead of two);
  - the draft conditions on EXACT history (all kv < pos comes from
    earlier dense verifies), so acceptance can only improve vs a
    sparse-history draft cache.
Exactness is untouched: speculative sampling is distribution-correct
for ANY draft process, and `p` is still the draft's actual sampling
distribution.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.engine.sampling import logits_to_probs
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


def _sample_probs(key, probs):
    return jax.random.categorical(key, jnp.log(probs + 1e-30), axis=-1)


def _spec_step(pt, pd, cache_t, cache_d, token, pos, th_t, th_d, key, *,
               k, temperature, top_k, target_cfg, draft_cfg, target_sp,
               draft_sp, shared_cache=False, k_eff=None,
               forced_alpha=None):
    """One draft-propose / target-verify round (traced; shared by the
    host-loop step and the on-device while_loop program).

    shared_cache (static): self-speculation on ONE cache — `cache_d`
    must be None; the draft writes in-round kv into `cache_t` and the
    dense verify overwrites those slots (module docstring). Returns
    cache_d=None in that mode.

    k_eff (traced scalar or None): adaptive speculation depth. Draft
    steps i >= k_eff are SKIPPED via lax.cond (no forward executed, no
    HBM traffic) and their proposals force-rejected, so the round
    proposes only k_eff tokens while the program keeps static shapes.
    k_eff == 0 degenerates to a plain target decode step (the verify's
    row 0 samples the target directly through the zero-padded residual).

    forced_alpha (static float or None): MEASUREMENT HARNESS ONLY —
    accept each in-depth draft with probability forced_alpha instead of
    the q/p rule, so throughput can be measured on the card at a
    calibrated acceptance rate on random weights whose own q/p
    acceptance is an artifact. NOT distribution-exact.

    Returns (tokens [k+1], n_valid, cache_t, cache_d, key)."""
    if shared_cache:
        assert cache_d is None, "shared_cache: pass cache_d=None"
        cache_d = cache_t

    # --- draft: up to k sequential tokens (steps >= k_eff skipped) ---
    def dbody(carry, i):
        tok, cache_d, key = carry
        key, sub = jax.random.split(key)

        def live(tok, cache_d):
            logits, cache_d = llama.forward(
                pd, tok[:, None], cache_d, pos + i, th_d,
                cfg=draft_cfg, sp=draft_sp,
            )
            probs = logits_to_probs(logits[0, 0], temperature, top_k)
            tok = _sample_probs(sub, probs)[None].astype(jnp.int32)
            return tok, cache_d, probs

        if k_eff is None:
            tok, cache_d, probs = live(tok, cache_d)
        else:
            # zero probs on the skipped branch make the residual at
            # acc_len == k_eff equal tprobs[k_eff] exactly (bonus-token
            # semantics), and the skipped forward costs nothing
            tok, cache_d, probs = jax.lax.cond(
                i < k_eff, live,
                lambda tok, cache_d: (
                    tok, cache_d,
                    jnp.zeros((draft_cfg.vocab_size,), jnp.float32)),
                tok, cache_d)
        return (tok, cache_d, key), (tok[0], probs)

    (last_tok, cache_d, key), (dtoks, dprobs) = jax.lax.scan(
        dbody, (token, cache_d, key), jnp.arange(k)
    )

    # --- target: verify in one forward over k+1 positions ---
    # (shared_cache: runs on the draft-updated cache and overwrites
    # pos..pos+k with exact dense kv)
    seq = jnp.concatenate([token, dtoks])[None, :]          # [1, k+1]
    tlogits, cache_t = llama.forward(
        pt, seq, cache_d if shared_cache else cache_t, pos, th_t,
        cfg=target_cfg, sp=target_sp,
    )
    tprobs = logits_to_probs(tlogits[0], temperature, top_k)  # [k+1, V]

    p = dprobs[jnp.arange(k), dtoks]                         # draft
    q = tprobs[jnp.arange(k), dtoks]                         # target
    key, kacc, kres = jax.random.split(key, 3)
    u = jax.random.uniform(kacc, (k,))
    if forced_alpha is None:
        accept = u < jnp.minimum(1.0, q / p)
    else:
        accept = u < jnp.float32(forced_alpha)
    if k_eff is not None:
        accept = accept & (jnp.arange(k) < k_eff)
    any_rej = jnp.any(~accept)
    acc_len = jnp.where(any_rej, jnp.argmax(~accept), k)

    # residual distribution at the rejection point; dprobs padded with a
    # zero row so acc_len == k degenerates to sampling tprobs[k]
    dprobs_pad = jnp.concatenate(
        [dprobs, jnp.zeros_like(tprobs[:1])], axis=0
    )
    residual = jnp.maximum(tprobs[acc_len] - dprobs_pad[acc_len], 0.0)
    residual = residual / jnp.maximum(residual.sum(), 1e-30)
    next_token = _sample_probs(kres, residual).astype(jnp.int32)

    if shared_cache:
        # no top-up: the verify just wrote dense kv at pos..pos+k, which
        # covers every position the next round can start from (this is
        # also why adaptive k_eff needs no staleness care here — every
        # slot the next round conditions on is dense-exact)
        cache_d = None
    else:
        # top up the draft cache with its own last token (ref :133-137).
        # Adaptive k_eff is shared-cache only: with a separate draft
        # cache, skipped steps would leave stale kv slots the next
        # round attends to.
        assert k_eff is None, "adaptive k requires shared_cache"
        _, cache_d = llama.forward(
            pd, dtoks[-1][None, None], cache_d, pos + k, th_d,
            cfg=draft_cfg, sp=draft_sp,
        )

    idx = jnp.arange(k + 1)
    out = jnp.where(idx < acc_len,
                    jnp.concatenate([dtoks, dtoks[-1:]]),
                    jnp.where(idx == acc_len, next_token, 0))
    return out, acc_len + 1, cache_t, cache_d, key


@functools.lru_cache(maxsize=32)
def build_speculative_step(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    *,
    speculate_k: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    target_sp: SparsityConfig = SparsityConfig(),
    draft_sp: SparsityConfig = SparsityConfig(),
    shared_params: bool = False,
    shared_cache: bool = False,
    forced_alpha: Optional[float] = None,
):
    """Returns a jitted step:
    (pt, pd, cache_t, cache_d, token[1], pos, th_t, th_d, key)
      -> (tokens[k+1], n_valid, cache_t, cache_d, key)

    forced_alpha: measurement harness (see _spec_step) — accept drafts
    at a fixed calibrated rate instead of the q/p rule. NOT exact.

    shared_params: see build_speculative_loop — avoids double-counting
    the weights at AOT compile when draft and target share buffers.
    shared_cache (requires shared_params): ONE cache for draft+target
    (module docstring); the caller's cache_d is ignored and the returned
    cache_d is the same array as cache_t.

    lru_cached: rebuilding the step per generate call would RETRACE the
    7B program on every call, a fixed cost of seconds of Python tracing
    that would be timed as part of each generate."""
    step = functools.partial(
        _spec_step, k=speculate_k, temperature=temperature, top_k=top_k,
        target_cfg=target_cfg, draft_cfg=draft_cfg, target_sp=target_sp,
        draft_sp=draft_sp, forced_alpha=forced_alpha,
    )
    if shared_cache:
        assert shared_params, "shared_cache requires shared params"

        @functools.partial(jax.jit, donate_argnums=(1,))
        def one_cache(p, cache, *rest):
            toks, n, c, _, key = step(p, p, cache, None, *rest,
                                      shared_cache=True)
            return toks, n, c, key

        def wrapped(pt, pd, cache_t, cache_d, *rest):
            toks, n, c, key = one_cache(pt, cache_t, *rest)
            return toks, n, c, c, key

        return wrapped
    if shared_params:
        shared = jax.jit(
            lambda p, cache_t, cache_d, *rest:
            step(p, p, cache_t, cache_d, *rest),
            donate_argnums=(1, 2))
        return lambda pt, pd, *rest: shared(pt, *rest)
    return jax.jit(step, donate_argnums=(2, 3))


@functools.lru_cache(maxsize=32)
def build_speculative_loop(
    target_cfg: ModelConfig,
    draft_cfg: ModelConfig,
    *,
    speculate_k: int,
    max_new_tokens: int,
    max_seq: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    target_sp: SparsityConfig = SparsityConfig(),
    draft_sp: SparsityConfig = SparsityConfig(),
    shared_params: bool = False,
    shared_cache: bool = False,
    forced_alpha: Optional[float] = None,
    adaptive_k: bool = False,
    k_min: int = 0,
    draft_cost_ratio: float = 0.5,
    overhead_ratio: float = 0.15,
    probe_every: int = 8,
):
    """The WHOLE generation loop as one jitted on-device program
    (`lax.while_loop` over speculative rounds; accepted tokens written at
    dynamic offsets into a fixed `[max_new + k]` buffer). One host sync
    per generation instead of one per round — the reference's Python loop
    (`generate.py:98-146`) pays a host round-trip every k tokens.

    Returns a jitted fn:
    (pt, pd, cache_t, cache_d, token[1], pos, th_t, th_d, key)
      -> (out_buf [max_new + k], n_out, n_rounds, pos_final, *caches)
    The trailing caches exist so the donated inputs can alias program
    outputs (XLA refuses the donation otherwise and copies the cache at
    entry); callers normally drop them.

    shared_params=True (self-speculation: the draft IS the target's
    weights, read at a sparser threshold schedule) drops `pd` from the
    program's parameter list and reuses `pt` for both roles. Without
    this, AOT compile accounts the two param pytrees separately even
    when the caller passes the same buffers — a 13.5 GB bf16 7B gets
    double-counted in the program's memory budget.
    shared_cache=True (requires shared_params): ONE cache for both roles
    (module docstring) — cache_d is dropped from the program too.

    forced_alpha (static float): measurement harness — accept drafts at
    a fixed calibrated rate instead of the q/p rule (NOT exact; see
    _spec_step).
    adaptive_k (shared_cache only): per-round speculation depth k_eff
    in [k_min, k]. The loop tracks a discounted acceptance estimate
    alpha_hat = acc/attempted (the truncated-geometric MLE) and sets
    k_eff = argmax_j E[tokens | alpha_hat, j] / (j*draft_cost_ratio +
    1 + overhead_ratio) — the throughput model with per-round costs in
    verify units. Draft steps >= k_eff are lax.cond-skipped (no HBM
    traffic), so a low-acceptance regime degrades toward the cost of a
    bare verify (~1 dense step per token, k_eff=0) instead of paying k
    wasted draft forwards (VERDICT r4 next #1c); every `probe_every`
    rounds k_eff is floored at 1 so the estimator keeps seeing fresh
    evidence and can re-escalate. Output distribution is untouched
    (speculative sampling is exact at ANY k, including k=0 where the
    zero-padded residual samples the target directly).
    """
    k = speculate_k
    if shared_cache:
        assert shared_params, "shared_cache requires shared params"
    if adaptive_k:
        assert shared_cache, "adaptive_k requires shared_cache " \
            "(a separate draft cache would go stale on skipped steps)"

    def _controller(acc_w, att_w):
        """k_eff from the discounted acceptance counters."""
        alpha_hat = jnp.clip(acc_w / jnp.maximum(att_w, 0.5), 0.02, 0.98)
        ks = jnp.arange(k + 1, dtype=jnp.float32)
        gain = (1.0 - alpha_hat ** (ks + 1.0)) / (1.0 - alpha_hat)
        cost = ks * draft_cost_ratio + 1.0 + overhead_ratio
        k_best = jnp.argmax(gain / cost).astype(jnp.int32)
        return jnp.clip(k_best, k_min, k), alpha_hat

    def run_impl(pt, pd, cache_t, cache_d, token, pos, th_t, th_d, key,
                 n_target):
        out_buf = jnp.zeros((max_new_tokens + k,), jnp.int32)
        pos = jnp.asarray(pos, jnp.int32).reshape(())
        # n_target (traced, <= max_new_tokens) bounds the loop WITHOUT
        # recompiling: benches sweep generation lengths through ONE
        # executable, so no length pays a compile
        bound = jnp.minimum(jnp.asarray(n_target, jnp.int32),
                            max_new_tokens)

        def cond(state):
            n_out, pos, *_ = state
            return (n_out < bound) & (pos + k + 1 < max_seq)

        def body(state):
            (n_out, pos, out_buf, token, cache_t, cache_d, key, rounds,
             acc_w, att_w) = state
            if adaptive_k:
                k_eff, _ = _controller(acc_w, att_w)
                k_eff = jnp.where(rounds % probe_every == 0,
                                  jnp.maximum(k_eff, 1), k_eff)
            else:
                k_eff = None
            toks, n_valid, cache_t, cache_d, key = _spec_step(
                pt, pd, cache_t, cache_d, token, pos, th_t, th_d, key,
                k=k, temperature=temperature, top_k=top_k,
                target_cfg=target_cfg, draft_cfg=draft_cfg,
                target_sp=target_sp, draft_sp=draft_sp,
                shared_cache=shared_cache, k_eff=k_eff,
                forced_alpha=forced_alpha,
            )
            if adaptive_k:
                # truncated-geometric MLE counters, discounted: acc_len
                # accepted out of acc_len (+1 if a rejection was seen)
                acc = (n_valid - 1).astype(jnp.float32)
                att = acc + ((n_valid - 1) < k_eff)
                acc_w = 0.9 * acc_w + acc
                att_w = 0.9 * att_w + att
            # write the k+1 candidate slots at the current offset; slots
            # past n_valid are overwritten by the next round (or sliced
            # off by the caller)
            out_buf = jax.lax.dynamic_update_slice(out_buf, toks, (n_out,))
            token = jax.lax.dynamic_slice(toks, (n_valid - 1,), (1,))
            return (n_out + n_valid, pos + n_valid, out_buf, token,
                    cache_t, cache_d, key, rounds + 1, acc_w, att_w)

        # optimistic prior (alpha_hat ~ 0.8) so the first rounds run
        # near full depth and the estimator converges from above
        n_out, pos, out_buf, _, cache_t, cache_d, _, rounds, acc_w, att_w \
            = jax.lax.while_loop(
                cond, body,
                (jnp.int32(0), pos, out_buf, token, cache_t, cache_d, key,
                 jnp.int32(0), jnp.float32(4.0), jnp.float32(5.0)),
            )
        if adaptive_k:
            k_fin, alpha_hat = _controller(acc_w, att_w)
            # extras BEFORE the caches: the jit wrappers below strip the
            # trailing caches positionally (donation aliasing), and
            # callers index out[0..3] the same in every mode
            return (out_buf, n_out, rounds, pos, k_fin, alpha_hat,
                    cache_t, cache_d)
        return out_buf, n_out, rounds, pos, cache_t, cache_d

    if shared_cache:
        @functools.partial(jax.jit, donate_argnums=(1,))
        def one_cache(p, cache, token, pos, th_t, th_d, key,
                      n_target=max_new_tokens):
            *out, cache_t, _ = run_impl(p, p, cache, None, token, pos,
                                        th_t, th_d, key, n_target)
            return (*out, cache_t)

        return lambda pt, pd, cache_t, cache_d, *rest: \
            one_cache(pt, cache_t, *rest)
    if shared_params:
        shared = jax.jit(
            lambda p, cache_t, cache_d, token, pos, th_t, th_d, key,
            n_target=max_new_tokens:
            run_impl(p, p, cache_t, cache_d, token, pos, th_t, th_d, key,
                     n_target),
            donate_argnums=(1, 2))
        return lambda pt, pd, *rest: shared(pt, *rest)

    @functools.partial(jax.jit, donate_argnums=(2, 3))
    def two(pt, pd, cache_t, cache_d, token, pos, th_t, th_d, key,
            n_target=max_new_tokens):
        return run_impl(pt, pd, cache_t, cache_d, token, pos, th_t,
                        th_d, key, n_target)

    return two


def speculative_generate(
    target_params, draft_params,
    target_cfg: ModelConfig, draft_cfg: ModelConfig,
    prompt_tokens,
    max_new_tokens: int,
    *,
    speculate_k: int = 5,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    max_seq: int = 2048,
    target_sp: SparsityConfig = SparsityConfig(),
    draft_sp: SparsityConfig = SparsityConfig(),
    target_thresholds=None,
    draft_thresholds=None,
    key=None,
    cache_dtype=jnp.bfloat16,
    device_loop: bool = False,
    shared_cache: Optional[bool] = None,
    n_target: Optional[int] = None,
    forced_alpha: Optional[float] = None,
    adaptive_k: bool = False,
    draft_cost_ratio: float = 0.5,
) -> Tuple[np.ndarray, dict]:
    """Returns (all tokens [T+new], stats).

    device_loop=False: host loop (one sync per round; interactive use).
    device_loop=True: the whole generation is one on-device while_loop
    program with a single host sync (build_speculative_loop).
    shared_cache: one KV cache for draft+target (module docstring);
    default: on exactly when the params are shared (self-speculation).
    n_target (device_loop only): dynamically bound the generation to
    n_target < max_new_tokens WITHOUT recompiling — benches sweep
    lengths through one executable.
    forced_alpha: measurement harness — fixed acceptance rate instead
    of the q/p rule (NOT exact).
    adaptive_k (device_loop + shared_cache): per-round speculation
    depth from the observed acceptance (build_speculative_loop)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    shared_params = target_params is draft_params
    if shared_cache is None:
        shared_cache = shared_params
    if shared_cache and not shared_params:
        raise ValueError("shared_cache requires target_params is "
                         "draft_params (self-speculation)")
    th_t = (target_thresholds if target_thresholds is not None
            else llama.zero_thresholds(target_cfg))
    th_d = (draft_thresholds if draft_thresholds is not None
            else llama.zero_thresholds(draft_cfg))

    prompt = jnp.asarray(prompt_tokens, jnp.int32).reshape(1, -1)
    t = prompt.shape[1]

    cache_t = KVCache.init(target_cfg, 1, max_seq, cache_dtype)

    # prefill on the prompt (shared cache: one dense prefill serves both
    # roles — the draft conditions on exact history anyway)
    key, kp = jax.random.split(key)
    logits, cache_t = llama.forward(
        target_params, prompt, cache_t, 0, th_t,
        cfg=target_cfg, sp=target_sp,
    )
    probs = logits_to_probs(logits[0, -1], temperature, top_k)
    cur = jax.random.categorical(
        kp, jnp.log(probs + 1e-30))[None].astype(jnp.int32)
    if shared_cache:
        cache_d = None
    else:
        cache_d = KVCache.init(draft_cfg, 1, max_seq, cache_dtype)
        _, cache_d = llama.forward(
            draft_params, prompt, cache_d, 0, th_d,
            cfg=draft_cfg, sp=draft_sp,
        )

    if device_loop:
        run = build_speculative_loop(
            target_cfg, draft_cfg, speculate_k=speculate_k,
            max_new_tokens=max_new_tokens - 1, max_seq=max_seq,
            temperature=temperature, top_k=top_k,
            target_sp=target_sp, draft_sp=draft_sp,
            shared_params=shared_params, shared_cache=shared_cache,
            forced_alpha=forced_alpha, adaptive_k=adaptive_k,
            draft_cost_ratio=draft_cost_ratio,
        )
        out = run(
            target_params, draft_params, cache_t, cache_d, cur, t,
            th_t, th_d, key,
            *(() if n_target is None else (n_target,)),
        )
        out_buf, n_out, rounds = out[0], out[1], out[2]
        n = int(n_out)
        r = max(int(rounds), 1)
        new = [int(np.asarray(cur)[0])] + [
            int(x) for x in np.asarray(out_buf)[:n]
        ]
        new = new[:max_new_tokens]
        all_tokens = np.concatenate(
            [np.asarray(prompt)[0], np.asarray(new, np.int64)]
        )
        stats = {
            "accepted_per_step": [],
            "mean_accepted": (n - r) / r,
            "new_tokens": len(new),
            "rounds": r,
        }
        if adaptive_k:
            stats["k_eff_final"] = int(out[4])
            stats["alpha_hat_final"] = float(out[5])
        return all_tokens, stats

    if adaptive_k:
        raise ValueError("adaptive_k requires device_loop=True")
    step = build_speculative_step(
        target_cfg, draft_cfg, speculate_k=speculate_k,
        temperature=temperature, top_k=top_k,
        target_sp=target_sp, draft_sp=draft_sp,
        shared_params=shared_params, shared_cache=shared_cache,
        forced_alpha=forced_alpha,
    )

    out = [int(np.asarray(cur)[0])]
    pos = t
    accept_counts = []
    while len(out) < max_new_tokens:
        toks, n_valid, cache_t, cache_d, key = step(
            target_params, draft_params, cache_t, cache_d, cur, pos,
            th_t, th_d, key,
        )
        toks = np.asarray(toks)
        n = int(n_valid)
        accept_counts.append(n - 1)
        take = min(n, max_new_tokens - len(out))
        out.extend(int(x) for x in toks[:take])
        pos += n
        cur = jnp.asarray(toks[n - 1 : n], jnp.int32)
        if pos + speculate_k + 1 >= max_seq:
            break

    all_tokens = np.concatenate(
        [np.asarray(prompt)[0], np.asarray(out, np.int64)]
    )
    stats = {
        "accepted_per_step": accept_counts,
        "mean_accepted": float(np.mean(accept_counts)) if accept_counts else 0.0,
        "new_tokens": len(out),
    }
    return all_tokens, stats
