"""Checkpoint ingest and native parameter store.

HF → engine conversion (the analog of
`gpt-fast/scripts/convert_hf_checkpoint.py:22-123`, minus its RoPE
un-permutation — our model uses the HF rotate-half convention directly, so
HF safetensors load unchanged): reads (sharded) safetensors, remaps keys,
transposes [out,in] projection weights to the [in,out] layout the model
multiplies with, and stacks per-layer tensors into `[L, ...]` arrays for the
scan-based forward.

Native format: one `.npy` per stacked leaf plus `meta.json`, loadable with
mmap so multi-GB models stream to device without a host-RAM spike
(the reference's `torch.load(mmap=True)` + meta-device trick,
`gpt-fast/generate.py:227-247`, done the numpy way).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from teal_jax.config import ModelConfig

# our stacked-leaf name -> HF per-layer tensor name
_LAYER_KEYMAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "wgate": "model.layers.{i}.mlp.gate_proj.weight",
    "wup": "model.layers.{i}.mlp.up_proj.weight",
    "wdown": "model.layers.{i}.mlp.down_proj.weight",
}
_TRANSPOSED = {"wq", "wk", "wv", "wo", "wgate", "wup", "wdown"}


class _SafetensorsIndex:
    """Uniform reader over a single or sharded-safetensors checkpoint dir."""

    def __init__(self, path: str):
        from safetensors import safe_open

        self._safe_open = safe_open
        self.path = path
        index_file = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_file):
            with open(index_file) as f:
                self.weight_map = json.load(f)["weight_map"]
        else:
            single = os.path.join(path, "model.safetensors")
            if not os.path.exists(single):
                cands = [f for f in os.listdir(path) if f.endswith(".safetensors")]
                if not cands:
                    raise FileNotFoundError(f"no safetensors under {path}")
                single = os.path.join(path, cands[0])
            with self._safe_open(single, framework="numpy") as f:
                self.weight_map = {k: os.path.basename(single) for k in f.keys()}
        self._handles: Dict[str, object] = {}

    def __contains__(self, key: str) -> bool:
        return key in self.weight_map

    def get(self, key: str) -> np.ndarray:
        fname = self.weight_map[key]
        if fname not in self._handles:
            self._handles[fname] = self._safe_open(
                os.path.join(self.path, fname), framework="numpy"
            ).__enter__()
        return self._handles[fname].get_tensor(key)


def load_hf_checkpoint(
    path: str, cfg: ModelConfig, dtype=jnp.bfloat16
) -> Dict:
    """HF safetensors checkpoint dir → stacked params pytree."""
    idx = _SafetensorsIndex(path)

    def grab(key: str, transpose: bool) -> np.ndarray:
        t = idx.get(key)
        if t.dtype == np.uint16:  # stored bf16 read as raw
            t = t.view(np.uint16)
            t = jnp.asarray(t).view(jnp.bfloat16)
            t = np.asarray(t.astype(jnp.float32))
        return np.ascontiguousarray(t.T) if transpose else t

    layers: Dict[str, np.ndarray] = {}
    keymap = dict(_LAYER_KEYMAP)
    if cfg.n_experts > 0:
        # Mixtral MoE: per-expert SwiGLU weights + router
        # (HF keys: block_sparse_moe.gate / experts.{e}.w1|w2|w3 where
        # w1=gate, w2=down, w3=up)
        for k in ("wgate", "wup", "wdown"):
            del keymap[k]
        keymap["router"] = "model.layers.{i}.block_sparse_moe.gate.weight"
        expert_map = {"wgate": "w1", "wdown": "w2", "wup": "w3"}
        for name, hf in expert_map.items():
            stack = []
            for i in range(cfg.n_layers):
                experts = [
                    grab(
                        f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight",
                        True,
                    )
                    for e in range(cfg.n_experts)
                ]
                stack.append(np.stack(experts))
            layers[name] = jnp.asarray(np.stack(stack), dtype)
    for name, pattern in keymap.items():
        transpose = name in _TRANSPOSED or name == "router"
        stack = [
            grab(pattern.format(i=i), transpose)
            for i in range(cfg.n_layers)
        ]
        layers[name] = jnp.asarray(np.stack(stack), dtype)

    embed = jnp.asarray(grab("model.embed_tokens.weight", False), dtype)
    if "lm_head.weight" in idx:
        lm_head = jnp.asarray(grab("lm_head.weight", True), dtype)
    else:  # tied embeddings
        lm_head = embed.T
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": jnp.asarray(grab("model.norm.weight", False), dtype),
        "lm_head": lm_head,
    }


# -- native format ------------------------------------------------------------

def _flatten(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def save_params(params, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    meta = {}
    for key, arr in flat.items():
        a = np.asarray(jax.device_get(arr))
        if a.dtype == jnp.bfloat16:
            np.save(os.path.join(path, key + ".npy"), a.view(np.uint16))
            meta[key] = {"dtype": "bfloat16"}
        else:
            np.save(os.path.join(path, key + ".npy"), a)
            meta[key] = {"dtype": str(a.dtype)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_params(path: str, device=None):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    params: Dict = {}
    for key, info in meta.items():
        a = np.load(os.path.join(path, key + ".npy"), mmap_mode="r")
        if info["dtype"] == "bfloat16":
            arr = jnp.asarray(np.asarray(a)).view(jnp.bfloat16)
        else:
            arr = jnp.asarray(np.asarray(a))
        if device is not None:
            arr = jax.device_put(arr, device)
        node = params
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return params
