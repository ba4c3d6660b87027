"""Tensor-parallel sharding specs (Megatron-style 1-D TP, the GSPMD way).

Equivalent capability to the reference's `gpt-fast/tp.py:54-156` — colwise
shards for q/k/v/gate/up, rowwise for o/down, head-sharded KV cache — but
expressed as `NamedSharding`s on the parameter pytree. XLA's SPMD
partitioner propagates the shardings through the forward and inserts the
all-reduce after the rowwise projections (the reference registers NCCL
all_reduce forward hooks by hand, tp.py:120-121,139-140).

Sparsity composes with TP exactly as in the reference: thresholds are
per-(layer, projection) scalars and the magnitude criterion is elementwise,
so applying them to a shard equals sharding the globally-sparsified tensor
(`tp_run.sh` demonstrates the same property upstream).
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from teal_jax.config import ModelConfig
from teal_jax.models.llama import KVCache


def _leaf_specs(leaf, wspec: P):
    """Specs for one projection entry: plain arrays take `wspec`
    directly; quantized dicts get a matching spec per field (the
    reference TP-shards its quantized Linears too — the published
    TP+int8/int4 70B rows, `gpt-fast/README.md:121-122`).

    wspec's last two entries cover the (K, N) dims. int8 scale is
    per-out-channel [..., N] -> wspec minus the K entry; int4 group
    params are [..., nb(, 1|2), N] -> the group dim shards like K.
    """
    if not isinstance(leaf, dict):
        return wspec
    dims = tuple(wspec)
    if "qp" in leaf:                 # packed int4 {"qp": [..,K/2,N],
        #                               "sz": [.., nb, 2, N]}
        return {"qp": wspec, "sz": P(*dims[:-2], dims[-2], None,
                                     dims[-1])}
    if "zero" in leaf:               # unpacked int4 {"q","scale","zero"}:
        #                               scale/zero [.., nb, N] — the
        #                               group dim shards like K
        return {"q": wspec, "scale": wspec, "zero": wspec}
    return {"q": wspec, "scale": P(*dims[:-2], dims[-1])}   # int8


def param_specs(cfg: ModelConfig, params=None):
    """PartitionSpec pytree matching the stacked params layout.

    colwise (output-dim) shards: wq wk wv wgate wup lm_head;
    rowwise (input-dim) shards: wo wdown (their matmuls end in a psum).

    Pass `params` to expand quantized {"q","scale"} / {"qp","sz"} dict
    leaves into matching per-field specs (without it, dict params would
    mismatch the spec tree).

    MoE (cfg.n_experts > 0): expert FFN stacks are [L, E, D, I] /
    [L, E, I, D]; each expert is sharded colwise/rowwise over its
    intermediate dim exactly like the dense FFN (the reference shards
    Mixtral experts the same way, `mixtral-moe/tp.py:146`
    `_apply_tp_moe_ffn`: w1/w3 colwise, w2 rowwise per expert); the
    router stays replicated (it is [D, E], tiny, and every rank needs
    the full routing decision).
    """
    layers = {
        "attn_norm": P(),
        "mlp_norm": P(),
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
    }
    if cfg.n_experts > 0:
        layers.update({
            "router": P(),
            "wgate": P(None, None, None, "tp"),
            "wup": P(None, None, None, "tp"),
            "wdown": P(None, None, "tp", None),
        })
    else:
        layers.update({
            "wgate": P(None, None, "tp"),
            "wup": P(None, None, "tp"),
            "wdown": P(None, "tp", None),
        })
    specs = {
        "embed": P(),
        "layers": layers,
        "final_norm": P(),
        "lm_head": P(None, "tp"),
    }
    if params is not None:
        specs["layers"] = {
            k: _leaf_specs(params["layers"][k], s)
            for k, s in layers.items()
        }
        specs["lm_head"] = _leaf_specs(params["lm_head"],
                                       specs["lm_head"])
    return specs


def cache_specs(dp: Optional[str] = "dp"):
    """KV cache [L, B, Hkv, S, Dh]: batch over dp (None for a 1-D tp
    mesh), heads over tp."""
    return KVCache(k=P(None, dp, "tp", None, None),
                   v=P(None, dp, "tp", None, None))


def _named(mesh: Mesh, spec_tree):
    return jax.tree.map(
        lambda s: NamedSharding(mesh, s), spec_tree,
        is_leaf=lambda s: isinstance(s, P),
    )


def shard_params(params, mesh: Mesh, cfg: ModelConfig):
    """Place params on the mesh with TP shardings.

    Requires n_heads, n_kv_heads and intermediate_size divisible by the tp
    axis size (the reference divides head counts the same way,
    tp.py:134-137).
    """
    tp = mesh.shape["tp"]
    for field, count in (("n_heads", cfg.n_heads),
                         ("n_kv_heads", cfg.n_kv_heads),
                         ("intermediate_size", cfg.intermediate_size)):
        if count % tp:
            raise ValueError(f"{field}={count} not divisible by tp={tp}")
    shardings = _named(mesh, param_specs(cfg, params))
    return jax.tree.map(jax.device_put, params, shardings)


def shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    shardings = _named(mesh, cache_specs(
        "dp" if "dp" in mesh.axis_names else None))
    return KVCache(
        k=jax.device_put(cache.k, shardings.k),
        v=jax.device_put(cache.v, shardings.v),
    )
