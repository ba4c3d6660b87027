"""GPTQ post-training quantization (capability parity with
`gpt-fast/GPTQ.py:132-345`'s Hessian-based runner, re-implemented from the
algorithm rather than ported from the fx.Interpreter machinery).

Quantizes a weight along its input dimension column-by-column, compensating
each column's rounding error through the remaining columns using the
inverse-Hessian (H = 2 X^T X from calibration activations) Cholesky factor.
Groupwise int4 (same packing as `quant.Int4Weight`) so GPTQ checkpoints run
through the existing int4 paths.

Host-side numpy: quantization is offline, numerically fussy (Cholesky), and
runs once per layer — the jit-worthy part is gathering the calibration
activations, which reuses the capture pipeline.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from teal_jax.ops.quant import Int4Weight


def _group_params(col_block: np.ndarray):
    """scale/zero (affine, 4-bit) for a [g, N] block, per output channel."""
    wmax = col_block.max(axis=0)
    wmin = col_block.min(axis=0)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8)
    zero = wmin
    return scale, zero


def _quant_col(col, scale, zero):
    q = np.clip(np.round((col - zero) / scale), 0, 15)
    return q, q * scale + zero


def gptq_quantize_int4(
    w: np.ndarray,
    x: np.ndarray,
    *,
    group: int = 128,
    percdamp: float = 0.01,
) -> Int4Weight:
    """w: [K, N] (input-major, as the model multiplies); x: [n, K]
    calibration inputs. Returns an Int4Weight with GPTQ-compensated values.
    """
    import jax.numpy as jnp

    K, N = w.shape
    assert K % group == 0, (K, group)
    W = np.array(w, dtype=np.float64)           # mutated in place
    X = np.asarray(x, dtype=np.float64)

    H = 2.0 * (X.T @ X)                          # [K, K]
    # dead inputs: keep H invertible, zero their weights (they contribute
    # nothing to the output on the calibration distribution)
    dead = np.diag(H) == 0
    H[dead, dead] = 1.0
    W[dead, :] = 0.0
    damp = percdamp * np.mean(np.diag(H))
    H[np.diag_indices(K)] += damp

    from scipy import linalg as sla

    Hinv = np.linalg.inv(H)
    # upper Cholesky factor: Hinv = T^T T (drives the error propagation)
    T = sla.cholesky(Hinv, lower=False)

    qvals = np.zeros((K, N), np.int8)
    scales = np.zeros((K // group, N), np.float32)
    zeros = np.zeros((K // group, N), np.float32)

    for g0 in range(0, K, group):
        g1 = g0 + group
        scale, zero = _group_params(W[g0:g1, :])
        scales[g0 // group] = scale
        zeros[g0 // group] = zero
        for i in range(g0, g1):
            col = W[i, :]
            q, deq = _quant_col(col, scale, zero)
            qvals[i] = (q - 8).astype(np.int8)
            err = (col - deq) / T[i, i]
            # propagate the rounding error into not-yet-quantized inputs
            W[i + 1:, :] -= np.outer(T[i, i + 1:], err)

    return Int4Weight(
        q=jnp.asarray(qvals),
        scale=jnp.asarray(scales, jnp.float32),
        zero=jnp.asarray(zeros, jnp.float32),
        group=group,
    )


def rtn_quantize_int4(w: np.ndarray, group: int = 128) -> Int4Weight:
    """Round-to-nearest baseline with identical packing (for comparisons)."""
    from teal_jax.ops.quant import quantize_int4
    import jax.numpy as jnp

    return quantize_int4(jnp.asarray(np.asarray(w, np.float32)), group=group)


def reconstruction_error(w_ref, wq: Int4Weight, x) -> float:
    """||x @ (w_ref - dequant(wq))||_F / ||x @ w_ref||_F."""
    from teal_jax.ops.quant import dequantize_int4
    import jax.numpy as jnp

    wd = np.asarray(dequantize_int4(wq, jnp.float32))
    num = np.linalg.norm(x @ (np.asarray(w_ref) - wd))
    den = np.linalg.norm(x @ np.asarray(w_ref)) + 1e-12
    return float(num / den)
