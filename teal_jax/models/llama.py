"""Functional Llama/Mistral transformer for activation-sparse inference.

One model serves calibration, accuracy eval, and fast decode (the reference
splits these across an HF-monkeypatch stack (`teal/model.py`) and a vendored
gpt-fast fork (`gpt-fast/model.py`); here they are the same forward under
different jit entry points).

Design notes:
  - Parameters are a pytree of *stacked* per-layer arrays (`[L, ...]`) and
    the layer loop is a `lax.scan`, keeping compile time flat in depth.
  - The KV cache is part of the scan carry and updated in place with
    `dynamic_update_slice`; callers donate it for buffer reuse.
  - Sparsity enters functionally: a `[L, 7]` threshold array (order
    `config.PROJS`) and a static `SparsityConfig`. Thresholds are data, so
    uniform vs. greedy (per-layer, per-projection) schedules need no
    retracing.
  - Norms, RoPE and softmax run in fp32; matmuls in the param dtype
    (bf16 by default) with fp32 accumulation via `preferred_element_type`.
  - RoPE uses the HF rotate-half convention so HF safetensors load without
    the reference's un-permutation step
    (`gpt-fast/scripts/convert_hf_checkpoint.py:75-81`).

Capture mode returns the four TEAL hidden-state groups per layer
(attn h1/h2, mlp h1/h2; reference `teal/self_attn.py:70-84,146-151`,
`teal/mlp.py:43-48`) for histogram calibration.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

from teal_jax.config import ModelConfig, PROJ_IDX, PROJS, SparsityConfig
from teal_jax.ops.sparsify import apply_sparsity
from teal_jax.ops import sparse_gemv


class KVCache(NamedTuple):
    """Static-shape decode cache. k/v: [L, B, n_kv_heads, max_seq, head_dim]."""

    k: jax.Array
    v: jax.Array

    @classmethod
    def init(cls, cfg: ModelConfig, batch: int, max_seq: int,
             dtype=jnp.bfloat16, n_kv_heads: Optional[int] = None):
        hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
        shape = (cfg.n_layers, batch, hkv, max_seq, cfg.head_dim)
        return cls(k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def rms_norm(x, weight, eps: float):
    xf = x.astype(jnp.float32)
    scale = jax.lax.rsqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + eps)
    return (xf * scale).astype(x.dtype) * weight.astype(x.dtype)


def precompute_rope(cfg: ModelConfig, max_seq: int):
    """cos/sin tables [max_seq, head_dim] (fp32), HF half-split convention."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (
        cfg.rope_base ** (jnp.arange(0, half, dtype=jnp.float32) / half)
    )
    t = jnp.arange(max_seq, dtype=jnp.float32)
    freqs = jnp.outer(t, inv_freq)                  # [S, half]
    emb = jnp.concatenate([freqs, freqs], axis=-1)  # [S, head_dim]
    return jnp.cos(emb), jnp.sin(emb)


def apply_rope(x, cos, sin):
    """x: [B, H, S, D]; cos/sin: [B, S, D] (gathered at each sequence's
    positions — per-sequence positions support continuous batching)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    xf = x.astype(jnp.float32)
    rf = rotated.astype(jnp.float32)
    c = cos[:, None]  # [B, 1, S, D] broadcasts over heads
    sn = sin[:, None]
    return (xf * c + rf * sn).astype(x.dtype)


def _proj(x, w, thresh, sp: SparsityConfig, *, proj: str, stacked=None,
          layer=None):
    """One of the seven sparsifiable projections: sparsify then matmul.

    Single-token decode with `sp.kernel` "gather" or "block" applies that
    kernel's selection rule and routes array weights through the sparse
    GEMV (`ops/sparse_gemv.py`); `stacked`/`layer` hand it the whole layer
    stack plus this layer's index so no per-layer weight copy is made.
    Otherwise (prefill, the accuracy path, quantized weights) this is the
    masked-dense matmul, matching reference semantics where prefill is
    dense in the fast engine (`kernels/sparse_gemv.py:271`).
    `w` may be a raw array, an int8 weight-only dict {"q", "scale"}, an
    int4 dict {"q", "scale", "zero"} or a packed int4 dict {"qp", "sz"}.
    """
    quantized = isinstance(w, dict)
    decode_kernel = (sp.enabled and x.shape[-2] == 1
                     and sp.kernel != "masked_dense")
    if decode_kernel and sp.block_keep_fracs:
        # greedy per-projection profile: this projection's keep fraction
        sp = sp.replace(block_keep_frac=sp.block_keep_fracs[PROJ_IDX[proj]])
    if decode_kernel and not quantized:
        if stacked is not None:
            return sparse_gemv.sparse_matmul(x, stacked, thresh, sp,
                                             layer=layer)
        return sparse_gemv.sparse_matmul(x, w, thresh, sp)
    if decode_kernel:
        xs = sparse_gemv.select(x, thresh, sp)
    else:
        xs = apply_sparsity(x, thresh, sp)
    if quantized:
        from teal_jax.ops import quant

        if "qp" in w:
            return quant.int4_packed_matmul(xs, w)
        if "zero" in w:
            return quant.int4_dict_matmul(xs, w)
        return quant.int8_matmul(xs, quant.Int8Weight(w["q"], w["scale"]))
    return jnp.matmul(xs, w, preferred_element_type=jnp.float32).astype(x.dtype)


def _can_cudnn_prefill(q, causal_prefill: bool, seq_axis) -> bool:
    """Static gate for cuDNN's fused attention in full-prompt prefill:
    pos == 0 (so causal masking over the fresh k/v is exact), a GPU, and
    the 16-bit types and head sizes cuDNN takes."""
    return (causal_prefill and seq_axis is None and q.shape[2] > 1
            and jax.default_backend() == "gpu"
            and q.dtype in (jnp.bfloat16, jnp.float16)
            and q.shape[-1] <= 128 and q.shape[-1] % 8 == 0)


def prefill_attention(q, k, v, sliding_window: Optional[int],
                      implementation: Optional[str] = None):
    """Causal attention of a full prompt over its own fresh k/v through
    `jax.nn.dot_product_attention` (cuDNN's fused kernel with
    implementation="cudnn" — a library kernel, not this repo's). GQA is
    native (Hkv divides Hq) and the sliding window is its
    `local_window_size`: the same mask as `_attention` at pos == 0.
    q: [B, Hq, S, D]; k/v: [B, Hkv, S, D]. Returns [B, Hq, S, D]."""
    window = (None if sliding_window is None
              else (sliding_window - 1, 0))
    out = jax.nn.dot_product_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), is_causal=True,
        local_window_size=window, implementation=implementation)
    return out.transpose(0, 2, 1, 3)


def _attention(q, k, v, pos, q_len: int, max_seq: int,
               sliding_window: Optional[int]):
    """Grouped-query attention over the full static cache.

    q: [B, Hq, S, D]; k/v: [B, Hkv, T, D] (T = max_seq cache length).
    `pos` [B] is each sequence's first query position. Invalid (future or
    beyond-window) cache slots are masked out; GQA is computed by reshaping
    q to [B, Hkv, G, S, D] so KV heads are never materialized G times
    (unlike the reference's `repeat_interleave`, `gpt-fast/model.py:247-248`).
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    q = q.reshape(b, hkv, g, s, d)
    scale = 1.0 / (d ** 0.5)

    scores = jnp.einsum(
        "bkgsd,bktd->bkgst", q, k, preferred_element_type=jnp.float32
    ) * scale

    q_pos = pos[:, None] + jnp.arange(s)[None, :]   # [B, S]
    t_pos = jnp.arange(max_seq)[None, None, :]      # [1, 1, T]
    valid = t_pos <= q_pos[:, :, None]              # [B, S, T]
    if sliding_window is not None:
        valid &= t_pos > (q_pos[:, :, None] - sliding_window)
    scores = jnp.where(valid[:, None, None], scores, -jnp.inf)

    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum(
        "bkgst,bktd->bkgsd", probs.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(b, hq, s, d).astype(v.dtype)


def layer_forward(h, lp: Dict[str, jax.Array], kc, vc, pos, cos, sin,
                  cfg: ModelConfig, sp: SparsityConfig, thresholds,
                  capture: bool = False, stacked=None, layer_idx=None,
                  causal_prefill: bool = False,
                  seq_axis: Optional[str] = None):
    """One transformer block. h: [B, S, D]; kc/vc: [B, Hkv, T, Dh].

    `seq_axis`: sequence-parallel prefill (parallel/sp.py) — h holds this
    device's contiguous chunk of the prompt and `pos` its global chunk
    start; K/V chunks are all-gathered over the axis and the full block
    written to the (replicated) cache, while local queries attend
    causally against it.

    thresholds: [7] per-projection scalars (order `config.PROJS`).
    `stacked`/`layer_idx`: the UN-sliced layer-stacked weight dict plus
    this layer's index — the sparse decode GEMV reads the stack in place
    (a per-layer slice fed to a custom call would be copied every step).
    Returns (h_out, kc, vc, captures|None).
    """
    b, s, d = h.shape
    pos = jnp.broadcast_to(jnp.atleast_1d(jnp.asarray(pos, jnp.int32)), (b,))
    if cos.ndim == 2:  # shared positions: broadcast over batch
        cos = jnp.broadcast_to(cos[None], (b,) + cos.shape)
        sin = jnp.broadcast_to(sin[None], (b,) + sin.shape)
    t = {p: thresholds[i] for i, p in enumerate(PROJS)}

    def proj(inp, name, p):
        st = None
        if stacked is not None and not isinstance(stacked[name], dict):
            st = stacked[name]
        return _proj(inp, lp[name], t[p], sp, proj=p, stacked=st,
                     layer=layer_idx)

    # --- attention ---
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)   # attn h1
    q = proj(x, "wq", "q")
    k = proj(x, "wk", "k")
    v = proj(x, "wv", "v")

    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(0, 2, 1, 3)
    hkv_local = kc.shape[1]
    k = k.reshape(b, s, hkv_local, cfg.head_dim).transpose(0, 2, 1, 3)
    v = v.reshape(b, s, hkv_local, cfg.head_dim).transpose(0, 2, 1, 3)

    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    upd = jax.vmap(
        lambda c, new, p: jax.lax.dynamic_update_slice(c, new, (0, p, 0))
    )
    if seq_axis is not None:
        # sequence-parallel prefill: gather every device's K/V chunk
        # (S-dim concat over the mesh axis) and write the full block
        # at the prompt base position — the cache stays replicated
        # while activations/queries remain S-sharded
        base = pos - jax.lax.axis_index(seq_axis) * s
        kc = upd(kc, jax.lax.all_gather(
            k, seq_axis, axis=2, tiled=True).astype(kc.dtype), base)
        vc = upd(vc, jax.lax.all_gather(
            v, seq_axis, axis=2, tiled=True).astype(vc.dtype), base)
    else:
        kc = upd(kc, k.astype(kc.dtype), pos)
        vc = upd(vc, v.astype(vc.dtype), pos)

    if _can_cudnn_prefill(q, causal_prefill, seq_axis):
        # pos == 0 full-prompt prefill over the fresh k/v (identical to
        # masked attention over the zero-initialized cache)
        attn = prefill_attention(q, k.astype(kc.dtype), v.astype(vc.dtype),
                                 cfg.sliding_window, implementation="cudnn")
    else:
        attn = _attention(q, kc, vc, pos, s, kc.shape[2], cfg.sliding_window)
    # attn h2 — cast back to the stream dtype (a cache dtype wider than
    # the compute dtype, e.g. fp32 cache + int8/bf16 weights, would
    # otherwise promote the residual stream and break the scan carry)
    attn = attn.transpose(0, 2, 1, 3).reshape(b, s, -1).astype(h.dtype)
    h = h + proj(attn, "wo", "o")

    # --- mlp ---
    y = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)    # mlp h1
    if cfg.n_experts > 0:
        # Mixtral MoE FFN: TEAL-sparse expert gathers on the decode path
        # (beyond the reference, whose mixtral-moe engine has no TEAL
        # hooks; SURVEY §2.3). Prefill stays dense.
        from teal_jax.models import moe

        h = h + moe.moe_ffn(y, lp, cfg, sp=sp, th_gu=t["gate"],
                            th_down=t["down"])
        caps = None
        if capture:
            # attention groups + the shared MoE FFN input (mlp h1).
            # Per-expert intermediates (the dense model's mlp h2) have no
            # single shared tensor; calibration skips that histogram
            # (beyond-reference: upstream has zero MoE-TEAL integration).
            caps = {"self_attn": {"h1": x, "h2": attn},
                    "mlp": {"h1": y}}
        return h, kc, vc, caps
    gate = proj(y, "wgate", "gate")
    up = proj(y, "wup", "up")
    inter = jax.nn.silu(gate.astype(jnp.float32)).astype(gate.dtype) * up
    # `inter` is mlp h2
    h = h + proj(inter, "wdown", "down")

    caps = None
    if capture:
        caps = {"self_attn": {"h1": x, "h2": attn},
                "mlp": {"h1": y, "h2": inter}}
    return h, kc, vc, caps


def compute_dtype(params):
    """Activation dtype: the projection dtype, or bf16 when projections are
    int8 weight-only dicts."""
    w = params["layers"]["wq"]
    if isinstance(w, dict):
        return jnp.bfloat16
    return w.dtype


def forward(params, tokens, cache: KVCache, pos, thresholds, *,
            cfg: ModelConfig, sp: SparsityConfig,
            return_hidden: bool = False, causal_prefill: bool = False,
            seq_axis: Optional[str] = None):
    """Full forward. tokens: [B, S] int32; pos: scalar start position
    shared by the batch, or [B] per-sequence positions (continuous
    batching: each slot decodes at its own depth).

    causal_prefill (static): caller guarantees pos == 0 and an empty
    cache (full-prompt prefill / ppl windows), enabling the fused
    prefill attention path on the GPU.

    Returns (logits [B, S, V] fp32, new_cache).
    """
    h = params["embed"][tokens].astype(compute_dtype(params))
    b, s = tokens.shape
    pos = jnp.broadcast_to(jnp.atleast_1d(jnp.asarray(pos, jnp.int32)), (b,))
    cos_full, sin_full = precompute_rope(cfg, cache.max_seq)
    positions = pos[:, None] + jnp.arange(s)[None, :]     # [B, S]
    cos = cos_full[positions]
    sin = sin_full[positions]

    def body(carry, xs):
        h, kc_all, vc_all = carry
        i, thresh_l = xs
        # lazy per-layer slices: XLA fuses them into dense consumers; the
        # sparse decode GEMV reads the stacked weights in place instead
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        kc = kc_all[i]
        vc = vc_all[i]
        h, kc, vc, _ = layer_forward(
            h, lp, kc, vc, pos, cos, sin, cfg, sp, thresh_l,
            stacked=params["layers"], layer_idx=i,
            causal_prefill=causal_prefill, seq_axis=seq_axis,
        )
        kc_all = jax.lax.dynamic_update_slice_in_dim(
            kc_all, kc[None], i, axis=0
        )
        vc_all = jax.lax.dynamic_update_slice_in_dim(
            vc_all, vc[None], i, axis=0
        )
        return (h, kc_all, vc_all), None

    idx = jnp.arange(cfg.n_layers)
    (h, kc, vc), _ = jax.lax.scan(
        body, (h, cache.k, cache.v), (idx, thresholds)
    )

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, KVCache(kc, vc)
    return _lm_head(params, h), KVCache(kc, vc)


def _lm_head(params, h):
    lmh = params["lm_head"]
    if isinstance(lmh, dict):
        # quantized output head (reference quantizes every nn.Linear
        # incl. self.output, quantize.py:312-317); XLA fuses the dequant
        # into the matmul's operand read
        from teal_jax.ops import quant

        if "zero" in lmh:        # int4 groupwise affine
            w = quant.dequantize_int4_dict(lmh, h.dtype)
            return jnp.matmul(h, w, preferred_element_type=jnp.float32)
        # int8 per-channel
        return jnp.matmul(
            h, lmh["q"].astype(h.dtype),
            preferred_element_type=jnp.float32,
        ) * lmh["scale"]
    return jnp.matmul(h, lmh, preferred_element_type=jnp.float32)


def zero_thresholds(cfg: ModelConfig):
    return jnp.zeros((cfg.n_layers, len(PROJS)), dtype=jnp.float32)


def init_params(cfg: ModelConfig, key, dtype=jnp.bfloat16):
    """Random-init parameters (benchmarks/tests; real weights come from
    `teal_jax.utils.checkpoint`)."""
    keys = jax.random.split(key, 4)

    def w(k, shape, scale=0.02):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    L, D, I, KV, V = (cfg.n_layers, cfg.dim, cfg.intermediate_size,
                      cfg.kv_dim, cfg.vocab_size)
    lk = jax.random.split(keys[0], 7)
    layers = {
        "attn_norm": jnp.ones((L, D), dtype),
        "mlp_norm": jnp.ones((L, D), dtype),
        "wq": w(lk[0], (L, D, D)),
        "wk": w(lk[1], (L, D, KV)),
        "wv": w(lk[2], (L, D, KV)),
        "wo": w(lk[3], (L, D, D)),
    }
    if cfg.n_experts > 0:
        from teal_jax.models import moe

        layers.update(moe.init_moe_ffn_params(cfg, lk[4], dtype))
    else:
        layers.update({
            "wgate": w(lk[4], (L, D, I)),
            "wup": w(lk[5], (L, D, I)),
            "wdown": w(lk[6], (L, I, D)),
        })
    return {
        "embed": w(keys[1], (V, D)),
        "layers": layers,
        "final_norm": jnp.ones((D,), dtype),
        "lm_head": w(keys[2], (D, V)),
    }


def param_bytes(params) -> int:
    return sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(params))
