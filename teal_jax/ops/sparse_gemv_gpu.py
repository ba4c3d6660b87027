"""Row-skipping sparse GEMV for single-token decode (Pallas, Triton route).

The design is the reference's split-K sparse GEMV
(`kernels/sparse_gemv.py:49-142`): weights are `[K, N]` row-major, so input
channel k owns one contiguous weight row of N elements, and a channel whose
activation is zero for every row of the batch skips that row. On a GPU the
skipped row is a masked load that is never issued, so the bytes read fall
with the activation sparsity.

  - Grid `(cdiv(N, block_n), cdiv(K, split_k))`: one program per output
    column tile and K split, enough programs in flight to fill the SMs
    (7B q-proj: 16 x 32 = 512).
  - A program walks its split in `block_k`-row chunks (unrolled). Per
    chunk it loads x[:, chunk] for all batch rows (padded to 16 for the
    dot), builds the row mask `any_b(x != 0)` and loads W[chunk, n-tile]
    under that mask, then accumulates `x @ W` in fp32.
  - Split-K partials of the B real rows go to a `[n_splits, B, N]` fp32
    buffer that XLA sums: one extra fp32 write/read of B*N per split
    (~3% of the weight bytes at B=1, split_k=128) that keeps the result
    deterministic, unlike the reference's fp16 `atomic_add`.

Selection is NOT done here: callers zero activations first (`sparsify` for
the elementwise rule, `sparsify_groups` for the group rule;
`ops/sparse_gemv.py`), and the kernel only skips rows whose x is zero. So
its result equals the dense `xs @ W` up to summation order.

Weights may be a layer stack `[L, K, N]` plus a traced layer index: the
kernel offsets into the stack itself, so a scan over layers never slices
(and copies) a layer's weights out to feed the custom call.

The kernel compiles only for an NVIDIA GPU. Elsewhere it runs only in
Pallas interpret mode, asked for explicitly (`interpret=True` or the
`interpret_mode()` context, which the CPU tests use); otherwise it raises.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# batch rows the kernel takes in one launch (pl.dot wants M >= 16)
MAX_ROWS = 16
# tile: output columns, K rows per program (split), K rows per unrolled
# chunk; warps and pipeline stages (the fastest of a sweep at the 7B
# shapes on an H100, PERF.md "Kernel decisions")
BLOCK_N, SPLIT_K, BLOCK_K = 256, 128, 32
NUM_WARPS, NUM_STAGES = 4, 2

_INTERPRET = False


@contextlib.contextmanager
def interpret_mode():
    """Run the kernel in Pallas interpret mode while tracing inside this
    context (CPU tests)."""
    global _INTERPRET
    prev, _INTERPRET = _INTERPRET, True
    try:
        yield
    finally:
        _INTERPRET = prev


def interpreting() -> bool:
    """True inside `interpret_mode()`."""
    return _INTERPRET


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def block_sizes(K: int, N: int):
    """(block_n, split_k, block_k) clamped to the shape: powers of two,
    at least 16 (the smallest Triton dot), no larger than needed."""
    bn = min(BLOCK_N, _pow2_at_least(N, 16))
    sk = min(SPLIT_K, _pow2_at_least(K, 16))
    bk = min(BLOCK_K, sk)
    return bn, sk, bk


def _kernel(layer_ref, x_ref, w_ref, o_ref, *, K: int, N: int, B: int,
            bn: int, sk: int, bk: int, precision):
    j = pl.program_id(0)
    s = pl.program_id(1)
    layer = layer_ref[0]
    rows = x_ref.shape[0]
    col_mask = n_mask = None
    if N % bn:
        col_mask = j * bn + jnp.arange(bn) < N
        n_mask = col_mask[None, :]
    acc = jnp.zeros((rows, bn), jnp.float32)
    for c in range(sk // bk):     # static: the chunks' loads are independent
        k0 = s * sk + c * bk
        k_ok = k0 + jnp.arange(bk) < K
        x = plgpu.load(x_ref.at[:, pl.ds(k0, bk)], mask=k_ok[None, :],
                       other=0.0)
        # a row is read only if some batch row has a nonzero activation
        live = (jnp.max(jnp.abs(x.astype(jnp.float32)), axis=0) > 0) & k_ok
        mask = jnp.broadcast_to(live[:, None], (bk, bn))
        if n_mask is not None:
            mask = mask & n_mask
        w = plgpu.load(w_ref.at[layer, pl.ds(k0, bk), pl.ds(j * bn, bn)],
                       mask=mask, other=0.0)
        acc += pl.dot(x.astype(w.dtype), w, precision=precision)
    # write only the B real rows of the padded batch, each with an
    # in-bounds 1-D store (a row is picked out of the tile by a masked sum)
    row_id = jnp.arange(rows)[:, None]
    for b in range(B):
        yb = jnp.sum(jnp.where(row_id == b, acc, 0.0), axis=0)
        plgpu.store(o_ref.at[s, b, pl.ds(j * bn, bn)], yb, mask=col_mask)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _sparse_gemv_2d(x, w, layer, *, interpret: bool):
    """x: [B, K] (B <= MAX_ROWS); w: [L, K, N]; layer: int32 scalar.
    Returns fp32 [B, N]."""
    B, K = x.shape
    _, _, N = w.shape
    bn, sk, bk = block_sizes(K, N)
    n_splits = pl.cdiv(K, sk)
    # pl.dot wants >= 16 rows: pad x (cheap); partials keep only B rows
    xp = jnp.zeros((MAX_ROWS, K), w.dtype).at[:B].set(x.astype(w.dtype))
    # fp32 weights (CPU tests) must not be rounded to TF32 on the GPU
    precision = (jax.lax.Precision.HIGHEST if w.dtype == jnp.float32
                 else None)
    kern = functools.partial(_kernel, K=K, N=N, B=B, bn=bn, sk=sk, bk=bk,
                             precision=precision)
    partial = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((n_splits, B, N), jnp.float32),
        grid=(pl.cdiv(N, bn), n_splits),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="sparse_gemv",
    )(jnp.reshape(layer, (1,)).astype(jnp.int32), xp, w)
    return jnp.sum(partial, axis=0)


def sparse_gemv(x, w, layer=None, *, interpret: Optional[bool] = None):
    """`x @ w` reading only the weight rows whose activation is nonzero in
    some batch row. x: [..., K] with at most MAX_ROWS leading elements;
    w: [K, N], or a stack [L, K, N] with `layer` the traced index.
    Returns [..., N] in x's dtype (fp32 accumulation).

    interpret: None follows `interpret_mode()`. On a backend other than
    the GPU the kernel runs only in interpret mode; otherwise this
    raises instead of falling back."""
    if interpret is None:
        interpret = _INTERPRET
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "sparse_gemv compiles only for an NVIDIA GPU (backend "
            f"{jax.default_backend()!r}); pass interpret=True or use "
            "interpret_mode() to run it in the Pallas interpreter")
    lead, K = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    if rows > MAX_ROWS:
        raise ValueError(f"sparse_gemv takes <= {MAX_ROWS} rows, got {rows}")
    if w.ndim == 2:
        w, layer = w[None], 0
    elif layer is None:
        raise ValueError("a stacked [L, K, N] weight needs `layer`")
    if w.shape[-2] != K:
        raise ValueError(f"x has K={K}, w has {w.shape}")
    y = _sparse_gemv_2d(x.reshape(rows, K), w, jnp.asarray(layer),
                        interpret=bool(interpret))
    return y.astype(x.dtype).reshape(*lead, w.shape[-1])
