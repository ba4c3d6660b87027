#!/usr/bin/env python
"""Single-GPU decode benchmark: dense vs sparse tokens/s at full width.

Measures decode tokens/s on the Llama-2-7B architecture (bf16, weights
made from a fixed pattern — decode speed is memory-bound and does not
depend on the values), dense vs the sparse decode path at `--sparsity`,
with the reference's protocol (tokens/s over a fixed decode run;
bandwidth = non-embedding weight bytes x tok/s,
`gpt-fast/generate.py:493-506`).

Timing is slope-based over two on-device scan lengths, each run ending in
`block_until_ready`, so launch and host overheads cancel.

Runs in ONE process on the GPU and fails when JAX finds none. Prints ONE
JSON line naming the device, the card and its power limit:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}
"""

import argparse
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _pattern(s):
    """Deterministic pseudo-random-looking values in [-0.02, 0.02)."""
    n = int(np.prod(s.shape))
    flat = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    vals = (flat >> 16).astype(jnp.float32) / 65536.0 - 0.5
    return (vals * 0.04).astype(s.dtype).reshape(s.shape)


def build(model_name: str, dtype=jnp.bfloat16):
    """(cfg, params) with every leaf filled from `_pattern` on device."""
    from teal_jax.config import get_model_config
    from teal_jax.models import llama

    cfg = get_model_config(model_name)
    t0 = time.time()
    shapes = jax.eval_shape(
        lambda: llama.init_params(cfg, jax.random.PRNGKey(0), dtype))
    params = jax.jit(lambda: jax.tree.map(_pattern, shapes))()
    jax.block_until_ready(params)
    log(f"params built in {time.time() - t0:.1f}s "
        f"({llama.param_bytes(params) / 1e9:.2f} GB)")
    return cfg, params


def decode_tps(cfg, params, sp, max_seq: int, n_short: int, n_long: int,
               reps: int = 3, batch: int = 1, thresholds=None) -> float:
    """Aggregate tokens/s from the slope of an on-device greedy decode
    scan between two lengths. thresholds: optional [L, 7] array (default
    zeros)."""
    from teal_jax.models import llama
    from teal_jax.models.llama import KVCache

    dtype = llama.compute_dtype(params)

    def make(n):
        @functools.partial(jax.jit, donate_argnums=(1,))
        def run(params, cache, token, thresholds):
            def body(carry, pos):
                token, cache = carry
                logits, cache = llama.forward(
                    params, token[:, None], cache, pos, thresholds,
                    cfg=cfg, sp=sp)
                tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
                return (tok, cache), ()

            (token, cache), _ = jax.lax.scan(
                body, (token, cache), jnp.arange(n, dtype=jnp.int32))
            # the cache is an output so the donated input aliases it
            return jnp.sum(token), cache

        return run

    run_s, run_l = make(n_short), make(n_long)
    th = (jnp.zeros((cfg.n_layers, 7), jnp.float32) if thresholds is None
          else jnp.asarray(thresholds, jnp.float32))

    def timed(fn, i):
        cache = KVCache.init(cfg, batch, max_seq, dtype)
        token = jnp.asarray([(i + j) % cfg.vocab_size
                             for j in range(batch)], jnp.int32)
        jax.block_until_ready((cache, token))
        t0 = time.perf_counter()
        out = fn(params, cache, token, th)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    t0 = time.time()
    timed(run_s, 0)
    timed(run_l, 1)
    log(f"compiled+warm in {time.time() - t0:.1f}s")
    slopes = []
    for r in range(reps):
        ts = timed(run_s, 2 + 2 * r)
        tl = timed(run_l, 3 + 2 * r)
        slopes.append((tl - ts) / (n_long - n_short))
    per_step = sorted(slopes)[len(slopes) // 2]
    if not per_step > 0:
        raise RuntimeError(f"non-positive decode slope {per_step!r}")
    return batch / per_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="7B")
    ap.add_argument("--sparsity", type=float, default=0.5,
                    help="fraction of channel groups zeroed per "
                         "projection (group rule, top-k)")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from teal_jax.config import SparsityConfig
    from teal_jax.utils.compile_cache import enable_compile_cache
    from teal_jax.utils.device import device_record

    enable_compile_cache()
    device = device_record()
    log(f"device: {device}")
    n_short, n_long = (4, 16) if args.quick else (8, 64)
    cfg, params = build(args.model)
    weight_gb = sum(cfg.proj_params(p) for p in
                    ("q", "k", "v", "o", "gate", "up", "down")
                    ) * cfg.n_layers * 2 / 1e9

    tps_dense = decode_tps(cfg, params, SparsityConfig(enabled=False),
                           args.max_seq, n_short, n_long, batch=args.batch)
    log(f"dense:  {tps_dense:.2f} tok/s "
        f"({weight_gb * tps_dense / args.batch:.0f} GB/s effective)")
    sparse_sp = SparsityConfig(enabled=True, kernel="block",
                               block_size=args.block_size,
                               block_keep_frac=1.0 - args.sparsity)
    tps_sparse = decode_tps(cfg, params, sparse_sp, args.max_seq, n_short,
                            n_long, batch=args.batch)
    log(f"sparse: {tps_sparse:.2f} tok/s")
    print(json.dumps({
        "metric": (f"sparse_decode_speedup_group"
                   f"{int(args.sparsity * 100)}pct_{args.model}"),
        "value": round(tps_sparse / tps_dense, 4),
        "unit": "x_vs_dense",
        "dense_tok_s": round(tps_dense, 2),
        "sparse_tok_s": round(tps_sparse, 2),
        "batch": args.batch,
        "max_seq": args.max_seq,
        "elementwise_equiv_sparsity": round(
            _elementwise_equiv(args.sparsity), 3),
        "device": device,
    }))


def expected_tokens_per_round(alpha: float, k: int) -> float:
    """Expected NEW tokens per speculative round at per-token acceptance
    rate alpha: the accepted prefix is geometric, plus the bonus/resample
    token — sum_{i=0..k} alpha^i. (The r4 bench quoted 1 + k*alpha,
    which overstates throughput at alpha < 1; VERDICT r4 weak #2.)"""
    if alpha >= 1.0:
        return float(k + 1)
    return (1.0 - alpha ** (k + 1)) / (1.0 - alpha)


def spec_slope_row(run, k: int, max_new: int, reps: int = 4,
                   alphas=(0.7, 0.85, 0.95, 1.0),
                   min_round_ms: float = 1.0):
    """The speculative-decoding measurement protocol.

    `run(n_target, rep) -> (wall_seconds, stats)` must sweep generation
    lengths through ONE executable (traced n_target bound). Protocol:
    interleaved min-per-length over THREE lengths, Theil-Sen (median of
    pairwise) slope of wall time over rounds. Per-call dispatch overhead
    can be large and jittery, so the caller must make max_new big enough
    that the round signal dominates: Delta-wall between the extreme
    lengths should be several times the jitter (a 3-point lstsq at
    max_new=128 once published garbage rows — SNR < 1).

    Sanity gates (walltime fallback, never publish garbage):
      - t_round within [min_round_ms, 10 s] (a self-spec round can never
        beat its own dense verify — callers pass a physical bound);
      - pairwise slopes must agree within 2x (jitter detector);
      - slope tok/s capped at 3x walltime tok/s."""
    lengths = sorted({max_new - 1, max(max_new // 2, k + 1),
                      max(max_new // 4, k + 1)}, reverse=True)
    best = {n: (float("inf"), None) for n in lengths}
    for rep in range(reps):
        for n in lengths:
            dt, st = run(n, rep)
            if dt < best[n][0]:
                best[n] = (dt, st)
    st_l = best[lengths[0]][1]
    r = np.array([best[n][1]["rounds"] for n in lengths], np.float64)
    tok = np.array([best[n][1]["new_tokens"] for n in lengths], np.float64)
    dt = np.array([best[n][0] for n in lengths], np.float64)
    pair_slopes = [
        (dt[i] - dt[j]) / (r[i] - r[j])
        for i in range(len(lengths)) for j in range(i + 1, len(lengths))
        if r[i] != r[j]
    ]
    t_round = float(np.median(pair_slopes)) if pair_slopes else float("nan")
    tok_per_round = float(np.median([
        (tok[i] - tok[j]) / (r[i] - r[j])
        for i in range(len(lengths)) for j in range(i + 1, len(lengths))
        if r[i] != r[j]
    ])) if pair_slopes else float("nan")
    wall_tps = float(tok[0] / dt[0])
    spread_ok = (len(pair_slopes) < 2 or min(pair_slopes) <= 0
                 or max(pair_slopes) / max(min(pair_slopes), 1e-9) <= 2.0)
    noisy = (not (min_round_ms * 1e-3 <= t_round <= 10.0)
             or not spread_ok
             or tok_per_round / t_round > 3.0 * wall_tps)
    if noisy:
        t_round = dt[0] / max(r[0], 1)
        tps = wall_tps
    else:
        tps = tok_per_round / t_round
    alpha = st_l["mean_accepted"] / k
    row = {
        "tok_s": round(tps, 2),
        "t_round_ms": round(t_round * 1e3, 2),
        "walltime_tok_s": round(wall_tps, 2),
        "k": k,
        "alpha_measured": round(alpha, 3),
        "tok_s_at_alpha": {
            str(a): round(expected_tokens_per_round(a, k) / t_round, 1)
            for a in alphas
        },
    }
    if noisy:
        row["noisy_slope_walltime_fallback"] = True
    return row


def _load_study():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "docs", "acceptance_study.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _study_alpha(keep: float, k: int):
    """Operating-point acceptance from a calibrated study artifact
    (docs/acceptance_study.json: {"alpha_table": [{"keep", "k",
    "alpha"}], "basis"}), or None when absent — the acceptance to quote
    instead of the random-weight artifact."""
    study = _load_study()
    if study:
        for row in study.get("alpha_table", []):
            if (abs(row["keep"] - keep) < 1e-6 and row.get("k") in (k, None)):
                return float(row["alpha"]), study.get("basis", "")
    return None


def _elementwise_equiv(group_sparsity: float) -> float:
    """Map a uniform GROUP sparsity to the elementwise-TEAL sparsity with
    equal dropped activation energy on the reference's real shipped
    channel statistics. Canonical curve lives in
    teal_jax/eval/accuracy_map.py (one source for bench, CLI and README
    tables); an honest headline states both axes."""
    from teal_jax.eval.accuracy_map import elementwise_equiv
    return elementwise_equiv(group_sparsity)




if __name__ == "__main__":
    main()
