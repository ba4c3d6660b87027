"""Tests that need an NVIDIA GPU: the sparse GEMV compiled by Triton (no
interpret mode) and cuDNN's prefill attention, each against the plain
reference. Skipped on the CPU by the `gpu` fixture; `chip_smoke.py` runs
them on the card (phase 6).

Tolerances: bf16 inputs and a different summation order than the fp32
reference — relative L2 error <= 1e-2 for the GEMV, 2e-2 for attention
(probabilities are rounded to bf16 before the PV product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.ops.sparse_gemv_gpu import sparse_gemv
from teal_jax.ops.sparsify import sparsify

pytestmark = pytest.mark.gpu


def _rel(got, want):
    got = np.asarray(got, np.float32).ravel()
    want = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("K,N", [(1024, 768), (1000, 300)])
def test_compiled_sparse_gemv_matches_reference(gpu, B, K, N):
    x = jax.random.normal(jax.random.PRNGKey(B), (B, K), jnp.bfloat16)
    xs = sparsify(x, 0.67)
    w = (jax.random.normal(jax.random.PRNGKey(1), (K, N)) * 0.02
         ).astype(jnp.bfloat16)
    got = sparse_gemv(xs, w, interpret=False)
    with jax.default_matmul_precision("highest"):
        want = jnp.matmul(xs.astype(jnp.float32), w.astype(jnp.float32))
    assert _rel(got, want) <= 1e-2


def test_compiled_stacked_layer_index(gpu):
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 512), jnp.bfloat16)
    ws = jax.random.normal(jax.random.PRNGKey(1), (3, 512, 256),
                           jnp.bfloat16)
    for layer in range(3):
        got = jax.jit(sparse_gemv)(x, ws, jnp.int32(layer))
        with jax.default_matmul_precision("highest"):
            want = jnp.matmul(x.astype(jnp.float32),
                              ws[layer].astype(jnp.float32))
        assert _rel(got, want) <= 1e-2


def test_model_decode_kernel_matches_masked_dense(gpu):
    cfg = get_model_config("tiny", dim=256, intermediate_size=512,
                           n_heads=2, n_kv_heads=2, vocab_size=128)
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    th = jnp.full((cfg.n_layers, 7), 0.5, jnp.float32)
    tok = jnp.array([[3], [9]], jnp.int32)

    def run(kernel):
        sp = SparsityConfig(enabled=True, kernel=kernel)
        cache = KVCache.init(cfg, 2, 16, jnp.bfloat16)
        fwd = jax.jit(lambda p, c: llama.forward(p, tok, c, 3, th,
                                                 cfg=cfg, sp=sp)[0])
        return fwd(params, cache)

    assert _rel(run("gather"), run("masked_dense")) <= 1e-2


@pytest.mark.parametrize("hq,hkv,window", [(8, 8, None), (8, 2, 64)])
def test_cudnn_prefill_attention_matches(gpu, hq, hkv, window):
    B, S, D = 1, 256, 128
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (B, hq, S, D), jnp.bfloat16)
    k = jax.random.normal(ks[1], (B, hkv, S, D), jnp.bfloat16)
    v = jax.random.normal(ks[2], (B, hkv, S, D), jnp.bfloat16)
    got = jax.jit(lambda q, k, v: llama.prefill_attention(
        q, k, v, window, implementation="cudnn"))(q, k, v)
    with jax.default_matmul_precision("highest"):
        want = llama._attention(
            q.astype(jnp.float32), k.astype(jnp.float32),
            v.astype(jnp.float32), jnp.zeros((B,), jnp.int32), S, S, window)
    assert _rel(got, want) <= 2e-2
