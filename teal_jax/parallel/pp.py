"""Pipeline parallelism over the layer-stacked parameter pytree.

Beyond-reference capability (upstream has only 1-D NCCL tensor
parallelism, `gpt-fast/tp.py:36-156`): the model's stacked `[L, ...]`
parameter layout makes pipeline staging a *sharding* — leaf dim 0 is
split over a `pp` mesh axis, so stage s owns layers
`[s*L/S, (s+1)*L/S)` with zero re-packing. The schedule is GPipe-style
microbatching expressed the SPMD way inside one `shard_map`:

  - every round, each stage runs its local layer slab (a `lax.scan`)
    on its in-flight microbatch;
  - hidden states hop stage s -> s+1 via `lax.ppermute`;
  - stage 0 feeds the next microbatch's embeddings into the pipe,
    the last stage writes logits;
  - rounds = n_micro + n_stages - 1 (fill + drain); invalid (fill/
    drain) rounds compute on don't-care buffers and their cache
    writes are masked out.

All stages execute an identical program every round (SPMD lockstep),
so the "bubble" costs nothing extra — idle stages would be in lockstep
anyway. The KV cache shards over `pp` on its layer dim like the params.

Composition with data/tensor parallelism: the shard_map is manual over
the `pp` axis ONLY (`axis_names={"pp"}`); any other mesh axes stay
automatic, so on a ("dp", "pp", "tp") mesh (make_pp_mesh(pp, dp=, tp=))
params placed with the combined pp×tp specs (pp_param_specs(..., cfg,
tp=True)) keep their `tp` shardings inside the body — GSPMD partitions
the projections and inserts the tp collectives per stage — while the
batch stays `dp`-sharded. ppermute/psum over `pp` are the only manual
collectives.

This module targets correctness + the multi-chip dryrun (virtual CPU
mesh); a production serving deployment would keep logits resident on
the last stage instead of the final `psum` broadcast, and lay the cache
out microbatch-major to avoid the per-round slab slice.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from teal_jax.config import ModelConfig, SparsityConfig
from teal_jax.models import llama
from teal_jax.models.llama import KVCache


def make_pp_mesh(pp: Optional[int] = None, devices=None, dp: int = 1,
                 tp: int = 1) -> Mesh:
    """("pp",) mesh, or ("dp", "pp", "tp") when dp/tp > 1 (composed
    3-D parallelism; degenerate axes are kept so specs stay uniform)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    pp = pp or n // (dp * tp)
    if pp * dp * tp > n:
        raise ValueError(f"dp*pp*tp={dp}*{pp}*{tp} > {n} devices")
    if dp > 1 or tp > 1:
        return Mesh(np.asarray(devices[:dp * pp * tp]).reshape(dp, pp, tp),
                    axis_names=("dp", "pp", "tp"))
    return Mesh(np.asarray(devices[:pp]).reshape(pp), axis_names=("pp",))


def _stage_spec(a):
    return P("pp", *([None] * (a.ndim - 1)))


def _with_pp(spec: P) -> P:
    """Prefix a layer-stacked leaf's tp spec with `pp` on the layer dim
    (tp.param_specs always leaves dim 0 — the L dim — unsharded)."""
    dims = tuple(spec)
    return P("pp", *dims[1:])


def pp_param_specs(params, cfg: Optional[ModelConfig] = None,
                   tp: bool = False):
    """PartitionSpec pytree: stacked layer leaves split over `pp` on dim 0
    (each stage owns a contiguous slab of layers); embeddings, final norm
    and lm_head replicated (stage 0 / last-stage use them; replication
    keeps the SPMD program uniform).

    tp=True (requires cfg): compose with tensor parallelism — layer
    leaves additionally carry the Megatron col/row `tp` shardings from
    `tp.param_specs` on their weight dims, and lm_head shards colwise."""
    if tp:
        from teal_jax.parallel import tp as tp_mod

        specs = tp_mod.param_specs(cfg, params)
        return {
            "embed": P(),
            "layers": jax.tree.map(
                _with_pp, specs["layers"],
                is_leaf=lambda s: isinstance(s, P)),
            "final_norm": P(),
            "lm_head": specs["lm_head"],
        }
    return {
        "embed": P(),
        "layers": jax.tree.map(_stage_spec, params["layers"]),
        "final_norm": P(),
        # lm_head may be a quantized {"q","scale"} dict — replicate
        # every leaf (spec tree must mirror the param subtree)
        "lm_head": jax.tree.map(lambda a: P(), params["lm_head"]),
    }


def pp_shard_params(params, mesh: Mesh, cfg: ModelConfig):
    pp = mesh.shape["pp"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    specs = pp_param_specs(params, cfg,
                           tp="tp" in mesh.axis_names
                              and mesh.shape["tp"] > 1)
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs
    )


def pp_shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    extra = mesh.axis_names != ("pp",)
    spec = (P("pp", "dp", "tp", None, None) if extra else P("pp"))
    s = NamedSharding(mesh, spec)
    return KVCache(k=jax.device_put(cache.k, s),
                   v=jax.device_put(cache.v, s))


def pp_forward(params, tokens, cache: KVCache, pos, thresholds, *,
               cfg: ModelConfig, sp: SparsityConfig, mesh: Mesh,
               n_micro: int = 2):
    """Pipelined forward. tokens: [B, S]; B % n_micro == 0.

    Returns (logits [B, S, V] fp32 — replicated across stages — and the
    pp-sharded updated cache). Jit-compatible: wrap the call (with static
    cfg/sp/mesh/n_micro) in `jax.jit`.
    """
    n_stages = mesh.shape["pp"]
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    n_rounds = n_micro + n_stages - 1

    pos_arr = jnp.broadcast_to(
        jnp.atleast_1d(jnp.asarray(pos, jnp.int32)), (b,)
    )
    layer_specs = jax.tree.map(_stage_spec, params["layers"])

    head_specs = jax.tree.map(lambda a: P(), params["lm_head"])

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), layer_specs, P(), head_specs, P(), P("pp"), P("pp"),
                  P(), P("pp", None)),
        out_specs=(P(), KVCache(P("pp"), P("pp"))),
        # manual over pp only: other mesh axes (dp, tp) stay automatic,
        # so tp-sharded params / dp-sharded batch are GSPMD-partitioned
        # inside each stage's program
        axis_names=frozenset({"pp"}),
        check_vma=False,
    )
    def run(embed, layers_local, final_norm, lm_head, tokens, kc_loc, vc_loc,
            pos_all, th_local):
        stage = jax.lax.axis_index("pp")
        l_local = kc_loc.shape[0]
        dtype = llama.compute_dtype({"layers": layers_local, "embed": embed})

        cos_full, sin_full = llama.precompute_rope(cfg, kc_loc.shape[3])
        positions = pos_all[:, None] + jnp.arange(s)[None, :]   # [B, S]
        cos_all = cos_full[positions]
        sin_all = sin_full[positions]

        def stage_layers(h, kc_mb, vc_mb, pos_m, cos, sin):
            def body(carry, xs):
                h, kc_all, vc_all = carry
                i, th_l = xs
                lp = jax.tree.map(lambda a: a[i], layers_local)
                kc = kc_all[i]
                vc = vc_all[i]
                h, kc, vc, _ = llama.layer_forward(
                    h, lp, kc, vc, pos_m, cos, sin, cfg, sp, th_l,
                )
                kc_all = jax.lax.dynamic_update_slice_in_dim(
                    kc_all, kc[None], i, axis=0)
                vc_all = jax.lax.dynamic_update_slice_in_dim(
                    vc_all, vc[None], i, axis=0)
                return (h, kc_all, vc_all), None

            (h, kc_mb, vc_mb), _ = jax.lax.scan(
                body, (h, kc_mb, vc_mb),
                (jnp.arange(l_local), th_local),
            )
            return h, kc_mb, vc_mb

        fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
        logits_buf = jnp.zeros((b, s, embed.shape[0]), jnp.float32)
        h0 = jnp.zeros((mb, s, cfg.dim), dtype)

        def round_body(r, carry):
            h_prev, kc_loc, vc_loc, logits_buf = carry
            m = r - stage
            valid = (m >= 0) & (m < n_micro)
            mc = jnp.clip(m, 0, n_micro - 1)
            off = mc * mb

            # stage 0 injects microbatch r's embeddings; others take the
            # ppermute'd hidden state from the previous stage
            tok_m = jax.lax.dynamic_slice_in_dim(tokens, off, mb, axis=0)
            h_in = jnp.where(stage == 0, embed[tok_m].astype(dtype), h_prev)

            pos_m = jax.lax.dynamic_slice_in_dim(pos_all, off, mb, axis=0)
            cos = jax.lax.dynamic_slice_in_dim(cos_all, off, mb, axis=0)
            sin = jax.lax.dynamic_slice_in_dim(sin_all, off, mb, axis=0)

            kc_mb = jax.lax.dynamic_slice_in_dim(kc_loc, off, mb, axis=1)
            vc_mb = jax.lax.dynamic_slice_in_dim(vc_loc, off, mb, axis=1)
            h_out, kc_new, vc_new = stage_layers(
                h_in, kc_mb, vc_mb, pos_m, cos, sin)

            # fill/drain rounds run on don't-care data: keep the cache
            kc_mb = jnp.where(valid, kc_new, kc_mb)
            vc_mb = jnp.where(valid, vc_new, vc_mb)
            kc_loc = jax.lax.dynamic_update_slice_in_dim(
                kc_loc, kc_mb, off, axis=1)
            vc_loc = jax.lax.dynamic_update_slice_in_dim(
                vc_loc, vc_mb, off, axis=1)

            # last stage emits logits for its (valid) microbatch
            # (llama._lm_head handles bf16 / int8 / int4 head formats)
            hn = llama.rms_norm(h_out, final_norm, cfg.norm_eps)
            logits_m = llama._lm_head({"lm_head": lm_head}, hn)
            write = (stage == n_stages - 1) & valid
            logits_buf = jnp.where(
                write,
                jax.lax.dynamic_update_slice_in_dim(
                    logits_buf, logits_m, off, axis=0),
                logits_buf,
            )

            # hop stage s -> s+1 (stage 0 receives zeros, unused)
            h_next = jax.lax.ppermute(h_out, "pp", fwd_perm)
            return (h_next, kc_loc, vc_loc, logits_buf)

        _, kc_loc, vc_loc, logits_buf = jax.lax.fori_loop(
            0, n_rounds, round_body, (h0, kc_loc, vc_loc, logits_buf)
        )
        # only the last stage wrote logits; broadcast them to every stage
        logits = jax.lax.psum(logits_buf, "pp")
        return logits, KVCache(kc_loc, vc_loc)

    return run(params["embed"], params["layers"], params["final_norm"],
               params["lm_head"], tokens, cache.k, cache.v, pos_arr,
               thresholds)
