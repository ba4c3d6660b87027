"""Sequence (context) parallelism for long-prompt prefill.

Beyond-reference capability: the prompt's sequence dimension is sharded
over an `sp` mesh axis, so prefill activation memory — the usual
long-context limiter, O(S * D * L) — scales down by the axis size while
every device stays busy on its contiguous token chunk.

The JAX formulation (one `shard_map`, explicit collectives):

  - each device ropes + projects its own chunk at its global positions;
  - per layer, K/V chunks are `all_gather`ed (S-dim concat) and the full
    block written to a REPLICATED KV cache at the prompt base — exactly
    the cache state single-device prefill would produce, so decode can
    proceed on any device/mesh afterwards;
  - local queries attend causally against the full cache (the standard
    all-gather-KV context parallelism; a ring schedule can replace the
    gather later without changing this interface);
  - logits come back S-sharded and are reassembled by the out_spec.

Composition with tensor parallelism: the shard_map is manual over the
`sp` axis ONLY (`axis_names={"sp"}`); any other mesh axes (e.g. `tp`)
stay automatic, so params placed with `tp.param_specs` shardings keep
them inside the body and GSPMD partitions the projections / inserts the
tp collectives exactly as on the plain TP path. `make_sp_mesh(sp, tp=t)`
builds the 2-D ("sp", "tp") mesh; the cache comes back replicated over
`sp` and head-sharded over `tp`, ready for TP decode on the same mesh
(the prefill→decode handoff, tests/test_composed.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


def make_sp_mesh(sp: Optional[int] = None, devices=None,
                 tp: int = 1) -> Mesh:
    """("sp",) mesh, or ("sp", "tp") when tp > 1 (composed
    sequence×tensor parallel prefill)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    sp = sp or n // tp
    if sp * tp > n:
        raise ValueError(f"sp*tp={sp}*{tp} > {n} devices")
    if tp > 1:
        return Mesh(np.asarray(devices[:sp * tp]).reshape(sp, tp),
                    axis_names=("sp", "tp"))
    return Mesh(np.asarray(devices[:sp]).reshape(sp), axis_names=("sp",))


def sp_prefill(params, tokens, cache: KVCache, pos, thresholds, *,
               cfg: ModelConfig, sp: SparsityConfig, mesh: Mesh):
    """Sequence-parallel prefill. tokens: [B, S] with S divisible by the
    sp axis size; `pos` is the scalar prompt base position (normally 0).

    Returns (logits [B, S, V] fp32, cache) — the cache replicated across
    the axis and identical to single-device prefill's.
    """
    n_sp = mesh.shape["sp"]
    b, s = tokens.shape
    if s % n_sp:
        raise ValueError(f"prompt length {s} not divisible by sp={n_sp}")
    s_local = s // n_sp
    pos = jnp.asarray(pos, jnp.int32).reshape(())

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(None, "sp"), KVCache(P(), P()), P(), P()),
        out_specs=(P(None, "sp", None), KVCache(P(), P())),
        # manual over sp only: other mesh axes (tp) stay automatic, so
        # tp-sharded params are GSPMD-partitioned inside the body
        axis_names=frozenset({"sp"}),
        check_vma=False,
    )
    def run(params, tok_local, cache, pos, thresholds):
        chunk = jax.lax.axis_index("sp")
        logits, cache = llama.forward(
            params, tok_local, cache, pos + chunk * s_local, thresholds,
            cfg=cfg, sp=sp, seq_axis="sp",
        )
        return logits, cache

    return run(params, tokens, cache, pos, thresholds)
