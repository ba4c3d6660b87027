"""Magnitude thresholding of hidden states ("the" sparsity op).

Semantics (parity with reference `utils/utils.py:32-52`):
  - keep rule: `|x| > t` (strict), output `x * keep`.
  - decode (seq == 1): always sparsified.
  - prefill (seq > 1): if `apply_prefill`, sparsify only the trailing
    `int(prefill_fraction * seq)` positions and leave the head dense
    (the reference hardcodes the fraction to 1/2 and notes 0.99 also works —
    paper §5.4.3); if not `apply_prefill`, prefill is left fully dense.

Sequence length is static under jit, so the prefill split is Python-level.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from teal_jax.config import SparsityConfig


def sparsify(x, threshold):
    """`x * (|x| > threshold)`. threshold may be scalar or broadcastable."""
    return jnp.where(jnp.abs(x) > threshold, x, jnp.zeros_like(x))


def effective_block_size(G: int, K: int) -> int:
    """The group size the group rule uses for input dim K: the requested
    size clamped to the largest power-of-two divisor of K that is <= the
    request, then doubled (up to 128) while K has more than 256 groups
    (e.g. down-proj K=11008: 32 -> 64). Calibrated group thresholds are
    built at this size (`calibration.thresholds.model_group_sizes`)."""
    g = G
    while g > 1 and (g > K or K % g):
        g //= 2
    while K // g > 256 and K % (g * 2) == 0 and g < 128:
        g *= 2
    return g


def group_scores(x, G: int):
    """Per-group max-|x| score. x: [1, K] -> [K//G]."""
    return jnp.max(jnp.abs(x).reshape(-1, G), axis=-1)


def block_sparse_matmul_reference(x, w, threshold, block_size: int = 32,
                                  keep_frac: Optional[float] = None):
    """Pure-jnp batch-1 group-rule projection, written independently of
    `sparsify_groups` (an index-set mask instead of a score cut): select
    groups of the one flattened row of x at the effective group size,
    then a dense matmul. keep_frac defaults to 0.625 (a capacity margin
    over 50% sparsity). x: [..., 1, K]; w: [K, N]."""
    K, N = w.shape
    G = effective_block_size(block_size, K)
    nb = K // G
    k_keep = max(1, min(nb, int(round(nb * (keep_frac or 0.625)))))
    lead = x.shape[:-1]
    xf = x.reshape(1, K)
    s = group_scores(xf, G)
    if threshold is not None:
        surv = s > threshold
        mask = surv & (jnp.cumsum(surv) <= k_keep)
    else:
        _, idx = jax.lax.top_k(s, k_keep)
        mask = jnp.zeros((nb,), bool).at[idx].set(True)
    xm = jnp.where(jnp.repeat(mask, G)[None, :], xf, 0)
    y = jnp.matmul(xm, w, preferred_element_type=jnp.float32).astype(x.dtype)
    return y.reshape(*lead, N)


def sparsify_groups(x, group_size: int, keep_frac: float,
                    threshold=None):
    """Group-granular sparsification: the group selection rule.

      - threshold mode (`threshold` given): keep groups whose max-|x|
        score is > threshold, scanned in ascending group-index order;
        the first `cap` survivors win, later survivors are dropped
        (capacity overflow).
      - top-k mode (`threshold=None`): keep the top `cap` groups by
        score.

    where cap = max(1, round(nb * keep_frac)). Selection is per position
    (per row of the leading dims). `kernel="block"` decode applies this
    rule and then skips the zeroed rows in the sparse GEMV.
    """
    *lead, d = x.shape
    nb = d // group_size
    if nb * group_size != d:
        raise ValueError(f"dim {d} not divisible by group {group_size}")
    k = max(1, min(nb, int(round(nb * keep_frac))))
    xg = x.reshape(*lead, nb, group_size)
    scores = jnp.max(jnp.abs(xg), axis=-1)              # [..., nb]
    if threshold is not None:
        surv = scores > threshold
        # capacity cap in index order: survivor rank = cumsum - 1
        mask = surv & (jnp.cumsum(surv, axis=-1) <= k)
    else:
        kth = jax.lax.top_k(scores, k)[0][..., -1:]
        mask = scores >= kth
    return (xg * mask[..., None].astype(x.dtype)).reshape(x.shape)


def apply_sparsity(x, threshold, cfg: SparsityConfig):
    """Apply the sparsity rule with the prefill policy. x: [..., seq, dim].

    cfg.mode selects the rule: "teal" is elementwise |x| > t (reference
    semantics); "group" is per-position group selection (the semantics of
    `kernel="block"` decode, for accuracy evaluation).
    """
    if not cfg.enabled:
        return x

    if cfg.mode == "group":
        G = effective_block_size(cfg.block_size, x.shape[-1])

        def rule(v):
            return sparsify_groups(
                v, G, cfg.block_keep_frac,
                threshold=threshold if cfg.block_thresholding else None,
            )
    else:
        def rule(v):
            return sparsify(v, threshold)

    seq = x.shape[-2]
    if seq > 1:
        if not cfg.apply_prefill:
            return x
        n_sparse = int(cfg.prefill_fraction * seq)
        if n_sparse == 0:
            return x
        head, tail = x[..., : seq - n_sparse, :], x[..., seq - n_sparse :, :]
        return jnp.concatenate([head, rule(tail)], axis=-2)
    return rule(x)
