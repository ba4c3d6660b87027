"""Mixtral-style mixture-of-experts FFN.

Capability parity with the reference's vanilla Mixtral engine
(`gpt-fast/mixtral-moe/model.py:187-231`): top-k softmax routing over E
experts, SwiGLU experts, outputs combined by normalized router weights. Beyond the
reference (whose mixtral-moe engine has no TEAL hooks; SURVEY §2.3), the
expert FFN is sparsity-integrated: `moe_ffn` applies the configured
selection rule to the routed input and to each expert's intermediate.

Decode (S == 1): only the k routed experts' weights are gathered/read —
the memory-bound analog of the reference's `ConditionalFeedForward`
indexing (`mixtral-moe/model.py:193-199`). Prefill: dense einsum over all
experts (compute-bound, simple and XLA-friendly at small contexts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from teal_jax.config import ModelConfig


def init_moe_ffn_params(cfg: ModelConfig, key, dtype=jnp.bfloat16):
    """Per-layer MoE FFN params (stacked [L, E, ...])."""
    L, D, I, E = (cfg.n_layers, cfg.dim, cfg.intermediate_size,
                  cfg.n_experts)
    ks = jax.random.split(key, 4)

    def w(k, shape, scale=0.02):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    return {
        "router": w(ks[0], (L, D, E)),
        "wgate": w(ks[1], (L, E, D, I)),
        "wup": w(ks[2], (L, E, D, I)),
        "wdown": w(ks[3], (L, E, I, D)),
    }


def _mm(y, w, scale=None):
    """Matmul against one expert's weight slice: plain array, or int8
    {"q","scale"} dequant-in-matmul (compute-dtype matmul then the
    per-out-channel scale — reference WeightOnlyBit8Linear /
    ConditionalFeedForwardBit8, `mixtral-moe/quantize.py:117-143`)."""
    if scale is not None:
        out = jnp.matmul(y, w.astype(y.dtype),
                         preferred_element_type=jnp.float32)
        return out * scale.astype(jnp.float32)
    return jnp.matmul(y, w, preferred_element_type=jnp.float32)


def _expert_ffn(y, wg, wu, wd, sg=None, su=None, sd=None,
                inter_rule=None):
    """SwiGLU through one expert's weights. y: [..., D]. `inter_rule`
    optionally sparsifies the intermediate before the down projection
    (per-expert — each routed expert's own intermediate is selected
    independently)."""
    gate = _mm(y, wg, sg)
    up = _mm(y, wu, su)
    inter = (jax.nn.silu(gate) * up).astype(y.dtype)
    if inter_rule is not None:
        inter = inter_rule(inter)
    return _mm(inter, wd, sd).astype(y.dtype)


def _wq(leaf, idx=None):
    """(weights, scale) for an expert leaf, optionally gathered by a
    routed-expert index array. int8 leaves are {"q": [L?,E,K,N],
    "scale": [L?,E,N]} dicts (quant.quantize_params_int8)."""
    if isinstance(leaf, dict):
        q, s = leaf["q"], leaf["scale"]
        if idx is not None:
            q, s = q[idx], s[idx]
        return q, s
    return (leaf if idx is None else leaf[idx]), None


def moe_ffn(y, lp, cfg: ModelConfig, sp=None, th_gu=None, th_down=None):
    """y: [B, S, D] -> [B, S, D].

    sp/th_gu/th_down: TEAL-sparse experts on the decode path, in plain
    XLA (the routed experts' weights are gathered and multiplied
    densely): gate/up select on the shared routed input with the mlp-h1
    threshold (one kept set serves every routed expert), down selects
    per expert on its intermediate with the h2 threshold. The group rule
    applies for `kernel="block"` or `mode="group"`, the elementwise rule
    otherwise. Prefill stays dense unless `sp.apply_prefill` (fast-engine
    semantics, reference `kernels/sparse_gemv.py:271`)."""
    k = cfg.n_experts_per_tok
    router_logits = jnp.matmul(
        y, lp["router"], preferred_element_type=jnp.float32
    )                                                # [B, S, E]
    top_vals, top_idx = jax.lax.top_k(router_logits, k)
    weights = jax.nn.softmax(top_vals, axis=-1)       # normalized over top-k

    b, s, d = y.shape
    if s == 1 and b <= 8:
        # decode: gather only the routed experts' weights. Batched (B<=8)
        # decode gathers per-token expert sets — B*k expert reads (the
        # memory-bound case the reference's ConditionalFeedForward b==1
        # indexing covers, mixtral-moe/model.py:193-199, extended to the
        # engine's slot batch).
        y_in = y[:, 0]
        inter_rule = None
        if sp is not None and sp.enabled and (sp.kernel == "block"
                                              or sp.mode == "group"):
            from teal_jax.ops.sparsify import (effective_block_size,
                                               sparsify_groups)

            gd = effective_block_size(sp.block_size, d)
            gi = effective_block_size(sp.block_size,
                                      cfg.intermediate_size)
            kf = sp.block_keep_fracs or (sp.block_keep_frac,) * 7
            y_in = sparsify_groups(
                y_in, gd, kf[4],
                threshold=th_gu if sp.block_thresholding else None)

            def inter_rule(inter):
                return sparsify_groups(
                    inter, gi, kf[6],
                    threshold=th_down if sp.block_thresholding else None)
        elif sp is not None and sp.enabled:
            # TEAL elementwise rule (accuracy path, mode="teal")
            from teal_jax.ops.sparsify import sparsify

            y_in = sparsify(y_in, th_gu)

            def inter_rule(inter):
                return sparsify(inter, th_down)

        idx = top_idx[:, 0]                           # [B, k]
        wg, sg = _wq(lp["wgate"], idx)                # [B, k, D, I]
        wu, su = _wq(lp["wup"], idx)
        wd, sd = _wq(lp["wdown"], idx)
        scales = () if sg is None else (sg, su, sd)
        outs = jax.vmap(jax.vmap(
            lambda *a: _expert_ffn(*a, inter_rule=inter_rule),
            in_axes=(None,) + (0,) * (3 + len(scales))
        ))(y_in, wg, wu, wd, *scales)                 # [B, k, D]
        w8 = weights[:, 0][..., None].astype(y.dtype)  # [B, k, 1]
        return jnp.sum(outs * w8, axis=1)[:, None, :]

    # prefill: run every expert, combine by routing weights. The
    # accuracy path's prefill sparsification rule applies here exactly
    # as for the dense model's projections (apply_sparsity: dense
    # prefill unless sp.apply_prefill, then the last-half rule,
    # reference utils/utils.py:34-43); routing always sees the dense y
    y_eff, inter_rule = y, None
    if sp is not None and sp.enabled:
        from teal_jax.ops.sparsify import apply_sparsity

        y_eff = apply_sparsity(y, th_gu, sp)

        def inter_rule(inter):
            return apply_sparsity(inter, th_down, sp)

    wg, sg = _wq(lp["wgate"])
    wu, su = _wq(lp["wup"])
    wd, sd = _wq(lp["wdown"])
    scales = () if sg is None else (sg, su, sd)
    all_out = jax.vmap(
        lambda g, u, dn, *sc: _expert_ffn(y_eff, g, u, dn, *sc,
                                          inter_rule=inter_rule),
        in_axes=0, out_axes=0,
    )(wg, wu, wd, *scales)                            # [E, B, S, D]
    onehot = jax.nn.one_hot(top_idx, cfg.n_experts, dtype=jnp.float32)
    combine = jnp.einsum("bske,bsk->ebs", onehot, weights)  # [E, B, S]
    return jnp.einsum(
        "ebsd,ebs->bsd", all_out.astype(jnp.float32), combine
    ).astype(y.dtype)
