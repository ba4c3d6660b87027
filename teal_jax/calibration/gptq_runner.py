"""Whole-model GPTQ: layer-streaming calibration + per-projection GPTQ.

The reference's GPTQ runner traces the model with dynamo and quantizes each
linear via a Hessian built from recorded eval-harness inputs
(`gpt-fast/GPTQ.py:132-345`). Here the existing capture pipeline provides
each projection's true input distribution (q/k/v <- attn h1, o <- attn h2,
gate/up <- mlp h1, down <- mlp h2 — the same four groups TEAL calibrates
thresholds on), and `ops.gptq` does the column-wise compensation. Output is
an int4 param pytree (`{"q","scale","zero"}` dicts) that runs through the
model's int4 dense path.

Propagation is block-sequential by default, matching the reference's
propagation granularity: after layer l's projections are quantized, the
layer's output is recomputed with the DEQUANTIZED weights, so layer l+1
calibrates on the activations it will actually see at inference
(accumulated quantization error included — `gpt-fast/GPTQ.py` runs each
traced module on the quantized prefix). `intra_block=True` additionally
sub-sequences WITHIN a block, in the traced dataflow order the
reference's fx-Interpreter walk provides (`gpt-fast/GPTQ.py:132-345`):
q/k/v calibrate on the block input, then wo on the attention output
computed with the QUANTIZED q/k/v, then gate/up on the post-attention
hidden state (quantized attention included), then wdown on
silu(gate)*up from the quantized gate/up — five staged forwards per
layer instead of two. `sequential=False` restores the cheaper one-shot
variant (one forward per layer; all layers see full-precision
activations).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig
from teal_jax.calibration.grab_acts import _layer_capture
from teal_jax.ops.gptq import gptq_quantize_int4

_PROJ_INPUT = {
    "wq": ("self_attn", "h1"),
    "wk": ("self_attn", "h1"),
    "wv": ("self_attn", "h1"),
    "wo": ("self_attn", "h2"),
    "wgate": ("mlp", "h1"),
    "wup": ("mlp", "h1"),
    "wdown": ("mlp", "h2"),
}


def _fit_group(K: int, group: int) -> int:
    for g in range(min(group, K), 0, -1):
        if K % g == 0:
            return g
    return 1


def gptq_quantize_model(
    params,
    cfg: ModelConfig,
    tokens,
    *,
    group: int = 128,
    percdamp: float = 0.01,
    sequential: bool = True,
    intra_block: bool = False,
    progress: bool = False,
) -> Dict:
    """Returns a params pytree with the seven projections as int4 dicts.

    sequential: propagate each layer's output through the QUANTIZED
    weights (reference behavior — downstream layers calibrate on the
    activations inference will produce). False = one-shot (full-precision
    propagation; one forward per layer instead of two).

    intra_block: also sub-sequence WITHIN each block (implies
    sequential): each projection group calibrates on intermediates
    recomputed with the already-quantized earlier projections of the
    same block (qkv -> o -> gate/up -> down, the traced dataflow order).
    Five forwards per layer instead of two.
    """
    from teal_jax.ops.quant import Int4Weight, dequantize_int4

    if intra_block and not sequential:
        raise ValueError("intra_block GPTQ requires sequential=True")
    tokens = jnp.asarray(tokens, jnp.int32)
    dtype = params["layers"]["wq"].dtype
    hidden = params["embed"][tokens].astype(dtype)

    # intra-block stages in dataflow order: each stage's projections
    # share one calibration capture taken AFTER the previous stage's
    # quantized weights were installed
    stages = (
        (("wq", "wk", "wv"), ("wo",), ("wgate", "wup"), ("wdown",))
        if intra_block
        else (tuple(_PROJ_INPUT),)
    )

    per_layer: Dict[str, list] = {k: [] for k in _PROJ_INPUT}
    for l in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[l], params["layers"])
        lq = dict(lp)
        for stage in stages:
            h_out, caps = _layer_capture(lq, hidden, cfg)
            for name in stage:
                module, htype = _PROJ_INPUT[name]
                w = np.asarray(lp[name], np.float32)
                x = np.asarray(caps[module][htype], np.float32).reshape(
                    -1, w.shape[0]
                )
                g = _fit_group(w.shape[0], group)
                wq = gptq_quantize_int4(w, x, group=g, percdamp=percdamp)
                per_layer[name].append(
                    {"q": np.asarray(wq.q), "scale": np.asarray(wq.scale),
                     "zero": np.asarray(wq.zero)}
                )
                if sequential:
                    lq[name] = dequantize_int4(
                        Int4Weight(q=wq.q, scale=wq.scale, zero=wq.zero,
                                   group=g),
                        dtype,
                    )
        if sequential:
            # re-run the layer on the quantized weights so the next
            # layer's Hessian sees the accumulated quantization error
            h_out, _ = _layer_capture(lq, hidden, cfg)
        hidden = h_out
        if progress:
            print(f"gptq layer {l}/{cfg.n_layers}", flush=True)

    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for name, stack in params["layers"].items():
        if name in per_layer:
            layers[name] = {
                key: jnp.asarray(np.stack([d[key] for d in per_layer[name]]))
                for key in ("q", "scale", "zero")
            }
        else:
            layers[name] = stack
    out["layers"] = layers
    return out
