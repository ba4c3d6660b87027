from teal_jax.parallel.mesh import make_mesh
from teal_jax.parallel.tp import shard_params, shard_cache, param_specs
from teal_jax.parallel.pp import (make_pp_mesh, pp_forward, pp_shard_cache,
                                  pp_shard_params)
from teal_jax.parallel.sp import make_sp_mesh, sp_prefill

__all__ = ["make_mesh", "shard_params", "shard_cache", "param_specs",
           "make_pp_mesh", "pp_forward", "pp_shard_cache", "pp_shard_params",
           "make_sp_mesh", "sp_prefill"]
