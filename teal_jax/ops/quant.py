"""Weight-only quantization (int8 per-channel, int4 groupwise).

Capability parity with the reference's PTQ stack (`gpt-fast/quantize.py`):
  - int8: symmetric per-output-channel scales
    (`dynamically_quantize_per_channel` :24-56, `WeightOnlyInt8Linear`
    forward = matmul in compute dtype then scale, :354-355);
  - int4: groupwise affine over the input dim with (scales, zeros) packed
    per group (`group_quantize_tensor` :58-162, `WeightOnlyInt4Linear`).

Sparse decode with quantized weights applies the selection rule and then
the dense dequantizing matmul below (XLA fuses the dequant into the dot's
operand read); the sparse GEMV takes 16-bit weights only.

Our weight layout is [in, out] (x @ w), so "per-channel" scales live on the
output axis (axis 1) and int4 groups run along the input axis (axis 0).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp

from teal_jax.ops.sparsify import effective_block_size


class Int8Weight(NamedTuple):
    q: jax.Array       # [K, N] int8
    scale: jax.Array   # [N] f32


class Int4Weight(NamedTuple):
    q: jax.Array       # [K, N] int8 holding values in [-8, 7]
    scale: jax.Array   # [K // group, N] f32
    zero: jax.Array    # [K // group, N] f32 (affine zero point)
    group: int


def quantize_int8(w) -> Int8Weight:
    """Symmetric per-output-channel int8."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0)                 # [N]
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(wf / scale[None, :]), -128, 127).astype(jnp.int8)
    return Int8Weight(q=q, scale=scale)


def dequantize_int8(wq: Int8Weight, dtype=jnp.bfloat16):
    return (wq.q.astype(jnp.float32) * wq.scale[None, :]).astype(dtype)


def int8_matmul(x, wq: Int8Weight):
    """Dense path: matmul in compute dtype, then per-channel scale
    (reference WeightOnlyInt8Linear.forward, quantize.py:354-355)."""
    y = jnp.matmul(x, wq.q.astype(x.dtype),
                   preferred_element_type=jnp.float32)
    return (y * wq.scale[None, :]).astype(x.dtype)


def quantize_int4(w, group: int = 128) -> Int4Weight:
    """Groupwise affine int4 along the input dim (reference group quant,
    quantize.py:58-162; groups of `group` input channels share
    scale/zero)."""
    K, N = w.shape
    assert K % group == 0, (K, group)
    wf = w.astype(jnp.float32).reshape(K // group, group, N)
    wmax = wf.max(axis=1)                                # [K//g, N]
    wmin = wf.min(axis=1)
    scale = jnp.maximum((wmax - wmin) / 15.0, 1e-8)
    zero = wmin
    q = jnp.clip(jnp.round((wf - zero[:, None, :]) / scale[:, None, :]),
                 0, 15) - 8
    return Int4Weight(
        q=q.reshape(K, N).astype(jnp.int8),
        scale=scale, zero=zero, group=group,
    )


def dequantize_int4(wq: Int4Weight, dtype=jnp.bfloat16):
    K, N = wq.q.shape
    g = wq.group
    qf = (wq.q.astype(jnp.float32) + 8.0).reshape(K // g, g, N)
    wf = qf * wq.scale[:, None, :] + wq.zero[:, None, :]
    return wf.reshape(K, N).astype(dtype)


def int4_matmul(x, wq: Int4Weight):
    """Dense path: dequantize-then-matmul (XLA fuses the dequant into the
    matmul's operand read)."""
    return jnp.matmul(x, dequantize_int4(wq, x.dtype),
                      preferred_element_type=jnp.float32).astype(x.dtype)


# -- packed int4 ---------------------------------------------------------------

def int4_pack_group(block_size: int, K: int) -> int:
    """Quant group of the packed int4 layout for input dim K: the group
    rule's effective size at `block_size`, at least 64."""
    return max(64, effective_block_size(block_size, K))


def pack_int4(wq: Int4Weight):
    """Int4Weight (quant group g) -> {"qp", "sz"} packed layout.

    qp [K/2, N] int8: rows [b*g, b*g + g/2) of nib = q+8 in the low
    nibbles, rows [b*g + g/2, (b+1)*g) in the high nibbles of packed
    rows [b*g/2, (b+1)*g/2) — pairing stays inside each quant group, so
    a group unpacks to naturally-ordered rows via one concatenate.
    sz [K//g, 2, N] f32: per-(group, out-channel) [scale, zero].
    """
    K, N = wq.q.shape
    g = wq.group
    if g % 2:
        raise ValueError(f"odd quant group {g}")
    nib = (wq.q.astype(jnp.int32) + 8).astype(jnp.uint8)
    r = nib.reshape(K // g, g, N)
    lo = r[:, : g // 2]
    hi = r[:, g // 2:]
    packed = (lo | (hi << 4)).astype(jnp.int8).reshape(K // 2, N)
    sz = jnp.stack([wq.scale, wq.zero], axis=1).astype(jnp.float32)
    return {"qp": packed, "sz": sz}


def unpack_int4(qp, sz, dtype=jnp.bfloat16):
    """Inverse of pack_int4 (XLA fuses the unpack+affine into the
    consuming matmul's operand read)."""
    K2, N = qp.shape[-2:]
    lead = qp.shape[:-2]
    nbg = sz.shape[-3]
    g = 2 * K2 // nbg
    pi = qp.astype(jnp.int32)
    lo = (pi & 15).reshape(*lead, nbg, g // 2, N)
    hi = ((pi >> 4) & 15).reshape(*lead, nbg, g // 2, N)
    nib = jnp.concatenate([lo, hi], axis=-2).astype(jnp.float32)
    w = nib * sz[..., 0:1, :] + sz[..., 1:2, :]
    return w.reshape(*lead, 2 * K2, N).astype(dtype)


def int4_packed_matmul(x, w: Dict):
    """Dense matmul against a packed int4 dict {"qp", "sz"}."""
    return jnp.matmul(x, unpack_int4(w["qp"], w["sz"], x.dtype),
                      preferred_element_type=jnp.float32).astype(x.dtype)


def pack_int4_params(params, block_size: int = 32) -> Dict:
    """Convert a whole int4 params pytree ({"q","scale","zero"} leaves,
    any quant group) to the packed layout ({"qp","sz"} leaves with quant
    group `int4_pack_group`). Leaves whose stored group differs are
    REQUANTIZED from the dequantized weights at that group (use
    `cli quantize --group-size 64` to avoid the extra lossy step for
    4k-dim models)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for name, leaf in params["layers"].items():
        if not (isinstance(leaf, dict) and "zero" in leaf):
            layers[name] = leaf
            continue
        L, K, N = leaf["q"].shape
        g_stored = K // leaf["scale"].shape[-2]
        G = int4_pack_group(block_size, K)
        packed = []
        for l in range(L):
            wq = Int4Weight(q=leaf["q"][l], scale=leaf["scale"][l],
                            zero=leaf["zero"][l], group=g_stored)
            if g_stored != G:
                wq = quantize_int4(dequantize_int4(wq, jnp.float32),
                                   group=G)
            packed.append(pack_int4(wq))
        layers[name] = {
            "qp": jnp.stack([p["qp"] for p in packed]),
            "sz": jnp.stack([p["sz"] for p in packed]),
        }
    out["layers"] = layers
    return out


# -- whole-model quantization -------------------------------------------------

def int4_dict_matmul(x, w: Dict):
    """Dense matmul against an int4 dict {"q", "scale", "zero"}; the group
    size is inferred from shapes (K // n_groups) so the dict stays a pure
    array pytree (scan-sliceable)."""
    K = w["q"].shape[-2]
    group = K // w["scale"].shape[-2]
    wq = Int4Weight(q=w["q"], scale=w["scale"], zero=w["zero"], group=group)
    return int4_matmul(x, wq)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


def quantize_params_int8(params) -> Dict:
    """Quantize the seven projection stacks AND lm_head to int8 (per
    layer, per channel). Each projection leaf becomes {"q": int8 [L,K,N],
    "scale": f32 [L,N]}; lm_head becomes {"q": int8 [D,V], "scale": [V]}
    (the reference's replace walks every nn.Linear incl. the output
    head, quantize.py:312-317; at Llama-3's 128k vocab the bf16 head
    alone reads 1 GB/token). Norms/embeddings stay as-is.

    MoE (Mixtral) expert stacks [L, E, K, N] quantize per (layer,
    expert, out-channel) -> {"q": int8 [L,E,K,N], "scale": [L,E,N]};
    the router stays fp, matching the reference's Mixtral quantizer
    which skips the gate (`mixtral-moe/quantize.py:56,73`)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    head = quantize_int8(out["lm_head"])
    out["lm_head"] = {"q": head.q, "scale": head.scale}

    def quant_stack(stack):
        if stack.ndim == 4:          # [L, E, K, N] expert stacks
            qs, ss = zip(*(quant_stack(stack[l])
                           for l in range(stack.shape[0])))
            return jnp.stack(qs), jnp.stack(ss)
        qs, ss = [], []
        for l in range(stack.shape[0]):
            wq = quantize_int8(stack[l])
            qs.append(wq.q)
            ss.append(wq.scale)
        return jnp.stack(qs), jnp.stack(ss)

    layers = {}
    for name, stack in params["layers"].items():
        if name in _QUANT_KEYS:
            q, s = quant_stack(stack)
            layers[name] = {"q": q, "scale": s}
        else:
            layers[name] = stack
    out["layers"] = layers
    return out


def quantize_params_int4(params, group: int = 128) -> Dict:
    """Quantize the seven projection stacks to groupwise-affine int4 (RTN;
    for Hessian-compensated quantization use
    `calibration.gptq_runner.gptq_quantize_model`). Each projection leaf
    becomes {"q": int8 [L,K,N] holding [-8,7], "scale": [L,K//g,N],
    "zero": [L,K//g,N]}; the group size is clamped per projection to
    divide its input dim (reference pads instead, quantize.py:426-428 —
    clamping preserves exact shapes for the scan). lm_head is quantized
    like the projections (the reference replaces every nn.Linear)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    gh = group
    while out["lm_head"].shape[0] % gh:
        gh //= 2
    head = quantize_int4(out["lm_head"], group=gh)
    out["lm_head"] = {"q": head.q, "scale": head.scale, "zero": head.zero}
    layers = {}
    for name, stack in params["layers"].items():
        if name in _QUANT_KEYS:
            K = stack.shape[-2]
            g = group
            while K % g:
                g //= 2
            qs, ss, zs = [], [], []
            for l in range(stack.shape[0]):
                wq = quantize_int4(stack[l], group=g)
                qs.append(wq.q)
                ss.append(wq.scale)
                zs.append(wq.zero)
            layers[name] = {"q": jnp.stack(qs), "scale": jnp.stack(ss),
                            "zero": jnp.stack(zs)}
        else:
            layers[name] = stack
    out["layers"] = layers
    return out


def param_is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def dequantize_int4_dict(w: Dict, dtype=jnp.bfloat16):
    K, N = w["q"].shape[-2:]
    g = K // w["scale"].shape[-2]
    qf = (w["q"].astype(jnp.float32) + 8.0).reshape(
        *w["q"].shape[:-2], K // g, g, N
    )
    wf = qf * w["scale"][..., :, None, :] + w["zero"][..., :, None, :]
    return wf.reshape(w["q"].shape).astype(dtype)
