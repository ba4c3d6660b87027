"""Sparse projection dispatch for single-token decode.

`SparsityConfig.kernel` picks the selection rule and the path:

  - "masked_dense": zero sub-threshold activations (`sparsify`), dense
    matmul. The accuracy path (identical semantics to reference
    `utils/utils.py:51-52`); it reads every weight byte.
  - "gather": the same elementwise rule, then the row-skipping sparse GEMV
    (`ops/sparse_gemv_gpu.py`), which reads only the weight rows of
    nonzero activations. Exact reference semantics.
  - "block": the group rule (`sparsify_groups` at `block_size`,
    `block_keep_frac`, with calibrated group-score thresholds when
    `block_thresholding` is set), then the same sparse GEMV.

The selection always runs as plain jnp before the kernel, so the kernel
path and its twin (selection + dense matmul) compute the same product; only
the bytes read differ. Batches above the kernel's row limit, and programs
traced under a multi-device mesh, run the twin.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from teal_jax.config import SparsityConfig
from teal_jax.ops import sparse_gemv_gpu
from teal_jax.ops.sparsify import (effective_block_size, sparsify,
                                   sparsify_groups)

# largest flattened batch the sparse GEMV serves in one launch; the rows
# share one row mask (`any_b(x != 0)`), so past a few rows it approaches
# dense and larger batches take the twin
KERNEL_MAX_ROWS = 8


def select(x, threshold, sp: SparsityConfig):
    """The decode-time selection rule of `sp.kernel`, applied per row."""
    if sp.kernel == "block":
        G = effective_block_size(sp.block_size, x.shape[-1])
        return sparsify_groups(
            x, G, sp.block_keep_frac,
            threshold=threshold if sp.block_thresholding else None)
    if sp.kernel in ("gather", "masked_dense"):
        return sparsify(x, threshold)
    raise ValueError(f"unknown sparse kernel {sp.kernel!r}")


def uses_kernel(x, sp: SparsityConfig) -> bool:
    """Static choice of the sparse GEMV for this projection input:
    single-token decode with at most KERNEL_MAX_ROWS rows, a kernel mode,
    and no multi-device mesh in context. The kernel is a per-device
    custom call, so a program traced under a mesh of several devices
    (`jax.set_mesh`, as the tensor/pipeline/sequence-parallel paths use)
    takes the twin rather than having weights gathered to feed it.

    On a backend other than the GPU the kernel then raises unless
    `sparse_gemv_gpu.interpret_mode()` is active: there is no silent
    fallback to the twin.
    """
    mesh = jax.sharding.get_abstract_mesh()
    return (sp.enabled and sp.kernel in ("gather", "block")
            and x.shape[-2] == 1
            and math.prod(x.shape[:-1]) <= KERNEL_MAX_ROWS
            and (mesh.empty or mesh.size == 1))


def sparse_matmul(x, w, threshold, sp: SparsityConfig, layer=None):
    """Decode-path sparse projection. x: [..., 1, K]; w: [K, N], or a
    layer stack [L, K, N] with `layer` its traced index."""
    xs = select(x, threshold, sp)
    if uses_kernel(x, sp):
        return sparse_gemv_gpu.sparse_gemv(xs, w, layer)
    if layer is not None:
        w = w[layer]
    return jnp.matmul(xs, w, preferred_element_type=jnp.float32).astype(x.dtype)
