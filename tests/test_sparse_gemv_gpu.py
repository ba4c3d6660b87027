"""The row-skipping sparse GEMV (ops/sparse_gemv_gpu.py) on the CPU: the
Pallas-Triton kernel in interpret mode against the plain reference, the
wrapper's shapes and padding, the choice between kernel and twin, plus the
runtime helpers that come with the GPU path (prefill attention through
`jax.nn.dot_product_attention`, the compile-cache placement and the
device checks)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig, get_model_config
from teal_jax.models import llama
from teal_jax.models.llama import KVCache
from teal_jax.ops import sparse_gemv, sparse_gemv_gpu
from teal_jax.ops.sparse_gemv_gpu import interpret_mode, sparse_gemv as sgemv
from teal_jax.ops.sparsify import (effective_block_size, sparsify,
                                   sparsify_groups)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sparsified(B, K, frac, rule, seed=0):
    """x [B, K] with `frac` of its activations zeroed by `rule`."""
    x = jax.random.normal(jax.random.PRNGKey(seed), (B, K), jnp.float32)
    if rule == "elementwise":
        t = jnp.quantile(jnp.abs(x), frac) if frac < 1.0 else jnp.inf
        return sparsify(x, t)
    G = effective_block_size(16, K)
    if frac >= 1.0:
        return jnp.zeros_like(x)
    return sparsify_groups(x, G, 1.0 - frac)


@pytest.mark.parametrize("K,N", [(256, 192), (300, 200)])
@pytest.mark.parametrize("rule", ["elementwise", "group"])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_kernel_matches_reference(B, frac, rule, K, N):
    """Interpret-mode kernel == fp32 `xs @ w` (K=300 is not a multiple of
    the default 128-row K split; N=200 not of the 256-column tile)."""
    xs = _sparsified(B, K, frac, rule, seed=B)
    w = jax.random.normal(jax.random.PRNGKey(7), (K, N), jnp.float32)
    got = sgemv(xs, w, interpret=True)
    want = jnp.matmul(xs, w, precision="highest")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    if frac == 1.0:
        assert not np.asarray(got).any()


def test_stacked_weights_read_the_indexed_layer():
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 128), jnp.float32)
    ws = jax.random.normal(jax.random.PRNGKey(2), (3, 128, 64), jnp.float32)
    for layer in range(3):
        got = sgemv(x, ws, jnp.int32(layer), interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(jnp.matmul(x, ws[layer],
                                                   precision="highest")),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lead", [(1,), (1, 1), (3, 1), (2, 2)])
def test_wrapper_keeps_leading_dims_and_dtype(lead):
    K, N = 64, 48
    x = jax.random.normal(jax.random.PRNGKey(3), lead + (K,), jnp.bfloat16)
    w = jax.random.normal(jax.random.PRNGKey(4), (K, N), jnp.bfloat16)
    got = sgemv(x, w, interpret=True)
    assert got.shape == lead + (N,) and got.dtype == jnp.bfloat16
    want = jnp.matmul(x.astype(jnp.float32), w.astype(jnp.float32),
                      precision="highest")
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want), rtol=2e-2, atol=2e-2)


def test_block_sizes_clamp_to_shape():
    assert sparse_gemv_gpu.block_sizes(4096, 11008) == (256, 128, 32)
    assert sparse_gemv_gpu.block_sizes(64, 48) == (64, 64, 32)
    assert sparse_gemv_gpu.block_sizes(20, 10) == (16, 32, 32)


@pytest.mark.parametrize("bad", ["rows", "k_mismatch", "no_layer"])
def test_wrapper_rejects_bad_shapes(bad):
    x = jnp.ones((1, 64), jnp.float32)
    w = jnp.ones((64, 32), jnp.float32)
    if bad == "rows":
        x = jnp.ones((sparse_gemv_gpu.MAX_ROWS + 1, 64), jnp.float32)
    elif bad == "k_mismatch":
        w = jnp.ones((32, 32), jnp.float32)
    else:
        w = jnp.ones((2, 64, 32), jnp.float32)
    with pytest.raises(ValueError):
        sgemv(x, w, interpret=True)


def test_cpu_without_interpret_raises():
    x = jnp.ones((1, 64), jnp.float32)
    w = jnp.ones((64, 32), jnp.float32)
    with pytest.raises(RuntimeError, match="GPU"):
        sgemv(x, w)
    # the model path raises too: no silent fallback to the twin
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(RuntimeError, match="interpret"):
        llama.forward(params, jnp.array([[3]], jnp.int32),
                      KVCache.init(cfg, 1, 8, jnp.float32), 0,
                      llama.zero_thresholds(cfg), cfg=cfg,
                      sp=SparsityConfig(enabled=True, kernel="gather"))


def test_gpu_backend_takes_the_compiled_kernel(monkeypatch):
    """On a GPU backend the decode projection reaches the Triton call
    (not interpret mode); the compile itself is stubbed out here."""
    calls = []

    def fake(x, w, layer, *, interpret):
        calls.append(interpret)
        return jnp.matmul(x.astype(jnp.float32), w[layer])

    monkeypatch.setattr(sparse_gemv_gpu.jax, "default_backend",
                        lambda: "gpu")
    monkeypatch.setattr(sparse_gemv_gpu, "_sparse_gemv_2d", fake)
    x = jnp.ones((1, 1, 64), jnp.float32)
    w = jnp.ones((64, 32), jnp.float32)
    sp = SparsityConfig(enabled=True, kernel="gather")
    sparse_gemv.sparse_matmul(x, w, 0.5, sp)
    assert calls == [False]


@pytest.mark.parametrize("case,expect", [
    ("decode", True), ("prefill", False), ("batch9", False),
    ("masked_dense", False), ("disabled", False), ("mesh", False)])
def test_kernel_choice(case, expect):
    sp = SparsityConfig(enabled=True, kernel="block")
    shape = (1, 1, 64)
    if case == "prefill":
        shape = (1, 4, 64)
    elif case == "batch9":
        shape = (9, 1, 64)
    elif case == "masked_dense":
        sp = sp.replace(kernel="masked_dense")
    elif case == "disabled":
        sp = sp.replace(enabled=False)
    x = jnp.ones(shape)
    if case == "mesh":
        mesh = jax.make_mesh((2,), ("tp",), devices=jax.devices()[:2])
        with jax.set_mesh(mesh):
            assert sparse_gemv.uses_kernel(x, sp) is expect
    else:
        assert sparse_gemv.uses_kernel(x, sp) is expect


@pytest.mark.parametrize("kernel", ["gather", "block"])
def test_model_decode_kernel_matches_twin(kernel):
    """A decode step through the kernel (interpret mode, batch 3) equals
    the same selection rule with a dense matmul."""
    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    th = jnp.full((cfg.n_layers, 7), 0.5, jnp.float32)
    sp = SparsityConfig(enabled=True, kernel=kernel, block_size=16,
                        block_keep_frac=0.5)
    tok = jnp.array([[3], [9], [27]], jnp.int32)

    def run(s):
        cache = KVCache.init(cfg, 3, 8, jnp.float32)
        return llama.forward(params, tok, cache, 2, th, cfg=cfg, sp=s)[0]

    with interpret_mode():
        got = run(sp)
    twin = (sp.replace(kernel="masked_dense") if kernel == "gather"
            else sp.replace(kernel="masked_dense", mode="group"))
    np.testing.assert_allclose(np.asarray(got), np.asarray(run(twin)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hq,hkv,window", [(4, 4, None), (8, 2, None),
                                           (8, 2, 5)])
def test_prefill_attention_matches_masked(hq, hkv, window):
    """`jax.nn.dot_product_attention` (XLA implementation here) with
    causal masking and `local_window_size` == `_attention` at pos 0."""
    B, S, D = 2, 16, 32
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (B, hq, S, D), jnp.float32)
    k = jax.random.normal(ks[1], (B, hkv, S, D), jnp.float32)
    v = jax.random.normal(ks[2], (B, hkv, S, D), jnp.float32)
    got = llama.prefill_attention(q, k, v, window, implementation="xla")
    want = llama._attention(q, k, v, jnp.zeros((B,), jnp.int32), S, S,
                            window)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    from teal_jax.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_check_refuses_the_cpu():
    from teal_jax.utils.device import NoGPUError, require_gpu

    with pytest.raises(NoGPUError):
        require_gpu()


def test_chip_smoke_refuses_the_cpu(capsys):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out
