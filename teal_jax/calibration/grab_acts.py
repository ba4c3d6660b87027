"""Activation capture → histogram calibration.

Streaming layer-by-layer capture of the four TEAL hidden-state groups and
construction of per-(layer, module, hidden-type) histograms, mirroring the
reference driver's behavior (`teal/grab_acts.py:63-97`): embed once, then
for each layer save the layer-input tensor (for the greedy optimizer), run
the layer in capture mode, build histograms, and move on. Layer-streaming
comes free: one jitted per-layer function is reused for every layer, so
memory stays O(one layer's activations) regardless of depth.

Artifact layout matches the reference scheme
(`<out>/histograms/layer-<i>/{self_attn,mlp}/...` with keys h1/h2, and
`<out>/activations/act_<i>.npz`) so TEAL's shipped calibration data is
interchangeable with ours.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.models import llama
from teal_jax.ops.distribution import Histogram, build_histogram, save_histograms


@functools.partial(jax.jit, static_argnames=("cfg",))
def _layer_capture(lp, hidden, cfg: ModelConfig):
    """Run one layer over a full sequence, returning output + captures."""
    b, s, _ = hidden.shape
    cos, sin = llama.precompute_rope(cfg, s)
    hkv = cfg.n_kv_heads
    kc = jnp.zeros((b, hkv, s, cfg.head_dim), hidden.dtype)
    vc = jnp.zeros_like(kc)
    sp = SparsityConfig(enabled=False)
    thresholds = jnp.zeros((7,), jnp.float32)
    h_out, _, _, caps = llama.layer_forward(
        hidden, lp, kc, vc, 0, cos, sin, cfg, sp, thresholds, capture=True
    )
    return h_out, caps


def calibrate(
    params,
    cfg: ModelConfig,
    tokens,
    out_dir: str,
    *,
    num_bins: int = 10000,
    outlier_threshold: float = 0.01,
    save_layer_inputs: bool = True,
    group_sizes=(32,),
    progress: bool = False,
) -> str:
    """Build histograms (and layer-input snapshots) from a token batch.

    tokens: [B, S] int array — the calibration corpus (reference uses 10
    sequences of 2048 alpaca tokens, `teal/grab_acts.py:56`).

    Besides the reference's elementwise h1/h2 histograms, also builds
    GROUP-SCORE histograms (keys `h1_g<G>`/`h2_g<G>`: per-position max-|x|
    over G-channel groups) for each size in `group_sizes` — the
    calibration data the block decode kernel's threshold mode needs
    (group-rule analog of the elementwise icdf rule).
    """
    tokens = jnp.asarray(tokens, jnp.int32)
    hidden = params["embed"][tokens].astype(params["layers"]["wq"].dtype)

    act_dir = os.path.join(out_dir, "activations")
    if save_layer_inputs:
        os.makedirs(act_dir, exist_ok=True)

    for l in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[l], params["layers"])
        if save_layer_inputs:
            np.savez_compressed(
                os.path.join(act_dir, f"act_{l}.npz"),
                hidden=np.asarray(hidden, np.float32),
            )
        hidden, caps = _layer_capture(lp, hidden, cfg)
        for module in ("self_attn", "mlp"):
            hists: Dict[str, Histogram] = {}
            for htype in ("h1", "h2"):
                if htype not in caps[module]:
                    continue  # MoE layers have no shared mlp h2
                vals = np.asarray(caps[module][htype], np.float32)
                hists[htype] = build_histogram(
                    vals, num_bins=num_bins, outlier_threshold=outlier_threshold
                )
                d = vals.shape[-1]
                for g in group_sizes:
                    if d % g:
                        continue
                    scores = np.abs(vals).reshape(-1, d // g, g).max(-1)
                    hists[f"{htype}_g{g}"] = build_histogram(
                        scores, num_bins=num_bins,
                        outlier_threshold=outlier_threshold,
                    )
            save_histograms(
                os.path.join(out_dir, "histograms", f"layer-{l}", module),
                hists,
            )
        if progress:
            print(f"calibrated layer {l}/{cfg.n_layers}", flush=True)
    return out_dir


def load_layer_input(out_dir: str, layer: int) -> np.ndarray:
    path = os.path.join(out_dir, "activations", f"act_{layer}.npz")
    return np.load(path)["hidden"]
