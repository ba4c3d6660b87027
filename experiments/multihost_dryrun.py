#!/usr/bin/env python
"""Multi-PROCESS dryrun: 2 simulated hosts x 4 virtual CPU devices.

The single-process dryrun (__graft_entry__.dryrun_multichip) validates
sharding/collectives on one process's virtual devices; this script
additionally validates the MULTI-HOST code path — jax.distributed
coordinator handshake, cross-process device enumeration, a global mesh
spanning both processes, process-local data placement, and programs
whose collectives cross the process boundary (DCN-analog).

Legs (--leg, each a fresh 2-process run; VERDICT r4 #7):
  gspmd     — GSPMD decode step on a dp=2 x tp=4 mesh (all-reduce
              crosses processes through the dp axis placement)
  pp        — pp=2 x tp=4 GPipe prefill: the stage boundary IS the
              process boundary, hidden states ppermute across it
  serving   — ContinuousBatchingEngine on a tp=8 global mesh: both
              processes run the identical host scheduling loop (SPMD
              host code), admission + batched decode cross-process

Usage (driver/worker auto-fork):
    timeout 900 python experiments/multihost_dryrun.py [--leg NAME]
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
LOCAL_DEVICES = 4
LEGS = ("gspmd", "pp", "serving")
BASE_PORT = 9764


def _leg_gspmd(pid, mesh_unused):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from teal_jax.config import SparsityConfig, get_model_config
    from teal_jax.models import llama
    from teal_jax.models.llama import KVCache
    from teal_jax.parallel import shard_cache, shard_params
    from teal_jax.parallel.distributed import global_mesh

    cfg = get_model_config("tiny", n_layers=2, n_heads=8, n_kv_heads=8,
                           dim=256, intermediate_size=512, vocab_size=512)
    mesh = global_mesh(tp=LOCAL_DEVICES, dp=N_PROC)

    # every process computes the same init (same seed) and device_put
    # places its addressable shards
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    with jax.set_mesh(mesh):
        params = shard_params(params, mesh, cfg)
        cache = shard_cache(KVCache.init(cfg, N_PROC, 16, jnp.float32),
                            mesh)
        tokens = jnp.tile(jnp.arange(4, dtype=jnp.int32)[None],
                          (N_PROC, 1))
        th = llama.zero_thresholds(cfg)

        @jax.jit
        def step(params, cache, tokens, th):
            return llama.forward(params, tokens, cache, 0, th, cfg=cfg,
                                 sp=SparsityConfig(enabled=True,
                                                   apply_prefill=False))

        logits, cache = step(params, cache, tokens, th)
        local = [np.asarray(s.data) for s in logits.addressable_shards]
    ok = all(np.isfinite(a).all() for a in local)
    print(f"[proc {pid}] multihost step ok={ok} "
          f"global logits {logits.shape} local shards {len(local)}",
          flush=True)
    assert ok


def _leg_pp(pid, _):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from teal_jax.config import SparsityConfig, get_model_config
    from teal_jax.models import llama
    from teal_jax.models.llama import KVCache
    from teal_jax.parallel import pp

    cfg = get_model_config("tiny", n_layers=2, n_heads=4, n_kv_heads=4,
                           dim=256, intermediate_size=512, vocab_size=128)
    params = llama.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    # pp is the MAJOR mesh axis: stage 0 = process 0's devices, stage 1 =
    # process 1's — every ppermute hop crosses the process boundary
    mesh = pp.make_pp_mesh(pp=N_PROC, tp=LOCAL_DEVICES)
    sharded = pp.pp_shard_params(params, mesh, cfg)
    cache = pp.pp_shard_cache(KVCache.init(cfg, 2, 16, jnp.float32), mesh)
    tokens = jnp.tile(jnp.arange(4, dtype=jnp.int32)[None] + 1, (2, 1))
    th = llama.zero_thresholds(cfg)
    # jit under set_mesh like __graft_entry__'s pp leg: EAGER
    # partially-manual shard_map trips jax's _unmatch rewrite on
    # committed dp/tp shardings ("out_specs refers to 'tp'")
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(
            lambda p, c, t: pp.pp_forward(
                p, tokens, c, 0, t, cfg=cfg,
                sp=SparsityConfig(enabled=False), mesh=mesh, n_micro=2)
        )(sharded, cache, th)
    local = [np.asarray(s.data) for s in logits.addressable_shards]
    ok = all(np.isfinite(a).all() for a in local)
    print(f"[proc {pid}] multihost pp ok={ok} logits {logits.shape}",
          flush=True)
    assert ok


def _leg_serving(pid, _):
    import jax
    import jax.numpy as jnp

    from teal_jax.config import get_model_config
    from teal_jax.engine.serving import ContinuousBatchingEngine
    from teal_jax.models import llama
    from teal_jax.parallel import tp as tp_mod
    from teal_jax.parallel.distributed import global_mesh

    tp = N_PROC * LOCAL_DEVICES
    cfg = get_model_config("tiny", n_layers=2, n_heads=8, n_kv_heads=8,
                           dim=1024, intermediate_size=1024,
                           vocab_size=128)
    params = llama.init_params(cfg, jax.random.PRNGKey(6), jnp.float32)
    mesh = global_mesh(tp=tp, dp=1)
    sharded = tp_mod.shard_params(params, mesh, cfg)
    with jax.set_mesh(mesh):
        # both processes run the IDENTICAL host scheduling loop on the
        # same submissions (SPMD host code): admission prefill, chunked
        # or not, and the batched decode step run as global programs
        eng = ContinuousBatchingEngine(
            cfg, sharded, slots=2, max_seq=32, temperature=0.0,
            cache_dtype=jnp.float32, prefill_chunk=8)
        eng.cache = tp_mod.shard_cache(eng.cache, mesh)
        eng.submit([1, 2, 3], 4)
        eng.submit(list(range(1, 13)), 3)     # 2-chunk admission
        finished = eng.run(max_steps=64)
    ok = (len(finished) == 2
          and all(len(r.out) == n for r, n in
                  zip(sorted(finished, key=lambda r: r.id), (4, 3))))
    print(f"[proc {pid}] multihost serving ok={ok} "
          f"outs={[r.out for r in finished]}", flush=True)
    assert ok


LEG_FNS = {"gspmd": _leg_gspmd, "pp": _leg_pp, "serving": _leg_serving}


def worker(pid: int, leg: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from teal_jax.parallel.distributed import initialize_distributed

    port = BASE_PORT + LEGS.index(leg)
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=N_PROC, process_id=pid)
    assert jax.process_count() == N_PROC, jax.process_count()
    assert jax.device_count() == N_PROC * LOCAL_DEVICES
    LEG_FNS[leg](pid, None)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", default="gspmd", choices=LEGS)
    args = ap.parse_args()
    if "MH_PROC" in os.environ:
        worker(int(os.environ["MH_PROC"]), args.leg)
        return
    procs = []
    for pid in range(N_PROC):
        env = dict(os.environ, MH_PROC=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--leg", args.leg],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    rc = 0
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=780)
        tail = b"\n".join(out.splitlines()[-6:]).decode(errors="replace")
        print(f"--- proc {pid} (rc={p.returncode}) ---\n{tail}",
              flush=True)
        rc |= p.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
