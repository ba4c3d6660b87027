"""GPTQ: must beat round-to-nearest on correlated calibration inputs."""

import numpy as np
import pytest

from teal_jax.ops.gptq import (
    gptq_quantize_int4,
    reconstruction_error,
    rtn_quantize_int4,
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    K, N, n = 128, 64, 512
    # correlated inputs (realistic activations): low-rank + noise
    basis = rng.normal(size=(16, K))
    x = rng.normal(size=(n, 16)) @ basis + 0.1 * rng.normal(size=(n, K))
    w = rng.normal(size=(K, N)) * 0.1
    return w, x


def test_gptq_beats_rtn(problem):
    w, x = problem
    g = 32
    q_gptq = gptq_quantize_int4(w, x, group=g)
    q_rtn = rtn_quantize_int4(w, group=g)
    e_gptq = reconstruction_error(w, q_gptq, x)
    e_rtn = reconstruction_error(w, q_rtn, x)
    assert e_gptq < e_rtn * 0.9, (e_gptq, e_rtn)


def test_gptq_packing_compatible(problem):
    """GPTQ output must run through the standard int4 dequant/matmul."""
    import jax.numpy as jnp

    from teal_jax.ops.quant import dequantize_int4, int4_matmul

    w, x = problem
    wq = gptq_quantize_int4(w, x, group=32)
    assert wq.q.dtype == jnp.int8
    assert wq.q.shape == w.shape
    assert int(wq.q.min()) >= -8 and int(wq.q.max()) <= 7
    y = int4_matmul(jnp.asarray(x[:4], jnp.float32), wq)
    assert np.isfinite(np.asarray(y)).all()
    # dequant stays within the affine range of each group
    wd = np.asarray(dequantize_int4(wq, jnp.float32))
    assert np.isfinite(wd).all()


def test_gptq_handles_dead_inputs(problem):
    w, x = problem
    x = x.copy()
    x[:, 7] = 0.0  # dead input channel
    wq = gptq_quantize_int4(w, x, group=32)
    e = reconstruction_error(w, wq, x)
    assert np.isfinite(e) and e < 0.5


def test_gptq_whole_model_runs_and_tracks_fp():
    import jax
    import jax.numpy as jnp

    from teal_jax.config import SparsityConfig, get_model_config
    from teal_jax.calibration.gptq_runner import gptq_quantize_model
    from teal_jax.models import llama
    from teal_jax.models.llama import KVCache

    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 32))
    qparams = gptq_quantize_model(params, cfg, toks, group=32)
    assert set(qparams["layers"]["wq"]) == {"q", "scale", "zero"}
    assert qparams["layers"]["wq"]["q"].dtype == jnp.int8

    ids = jnp.asarray(toks[:, :8], jnp.int32)
    sp = SparsityConfig()
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = llama.forward(params, ids, cache, 0,
                           llama.zero_thresholds(cfg), cfg=cfg, sp=sp)
    cache = KVCache.init(cfg, 1, 8, jnp.bfloat16)
    got, _ = llama.forward(qparams, ids, cache, 0,
                           llama.zero_thresholds(cfg), cfg=cfg, sp=sp)
    rel = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    assert np.isfinite(np.asarray(got)).all()
    assert rel < 0.25, rel


def test_gptq_pack_roundtrip_through_gather_kernel(problem):
    """GPTQ int4 -> nibble-pack -> packed int4 matmul: end-to-end
    (quantize CLI int4-gptq artifacts drive the decode path)."""
    import jax.numpy as jnp

    from teal_jax.ops import quant

    w, x = problem  # w [K, N]
    K = w.shape[0]
    wq = gptq_quantize_int4(w, x, group=64)
    packed = quant.pack_int4(wq)
    wd = np.asarray(quant.dequantize_int4(wq, jnp.float32))
    # packed unpack is exactly the affine dequant
    wu = np.asarray(quant.unpack_int4(packed["qp"], packed["sz"],
                                      jnp.float32))
    np.testing.assert_allclose(wu, wd, rtol=1e-5, atol=1e-5)

    xv = jnp.asarray(x[:1], jnp.float32)
    y = quant.int4_packed_matmul(xv, packed)
    ref = np.asarray(xv) @ wd
    np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-3, atol=1e-2)


def test_gptq_sequential_propagation_semantics():
    """Sequential (default) vs one-shot GPTQ: layer 0 calibrates on
    identical inputs either way; deeper layers see the quantized
    prefix's activations only in sequential mode (reference propagation,
    gpt-fast GPTQ.py runs each module on the quantized prefix)."""
    import jax
    import jax.numpy as jnp

    from teal_jax.config import get_model_config
    from teal_jax.calibration.gptq_runner import gptq_quantize_model
    from teal_jax.models import llama

    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(2), jnp.float32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 32))
    seq = gptq_quantize_model(params, cfg, toks, group=32, sequential=True)
    one = gptq_quantize_model(params, cfg, toks, group=32, sequential=False)

    q_seq = np.asarray(seq["layers"]["wq"]["q"])
    q_one = np.asarray(one["layers"]["wq"]["q"])
    np.testing.assert_array_equal(q_seq[0], q_one[0])
    assert any(
        not np.array_equal(np.asarray(seq["layers"][n]["q"])[1:],
                           np.asarray(one["layers"][n]["q"])[1:])
        for n in ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")
    ), "sequential propagation changed no downstream quantization"


def test_gptq_intra_block_subsequencing():
    """intra_block=True sub-sequences within each block: q/k/v calibrate
    on the block input (same either way), but wo calibrates on the
    attention output recomputed with the QUANTIZED q/k/v — so layer 0's
    qkv match block-sequential while its wo (and later stages) diverge.
    The result must still run the int4 dense path and track fp."""
    import jax
    import jax.numpy as jnp

    from teal_jax.config import SparsityConfig, get_model_config
    from teal_jax.calibration.gptq_runner import gptq_quantize_model
    from teal_jax.models import llama
    from teal_jax.models.llama import KVCache

    cfg = get_model_config("tiny")
    params = llama.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 32))
    blk = gptq_quantize_model(params, cfg, toks, group=32, sequential=True)
    sub = gptq_quantize_model(params, cfg, toks, group=32, sequential=True,
                              intra_block=True)

    for n in ("wq", "wk", "wv"):
        np.testing.assert_array_equal(
            np.asarray(sub["layers"][n]["q"])[0],
            np.asarray(blk["layers"][n]["q"])[0])
    assert any(
        not np.array_equal(np.asarray(sub["layers"][n]["q"])[0],
                           np.asarray(blk["layers"][n]["q"])[0])
        for n in ("wo", "wgate", "wup", "wdown")
    ), "intra-block sub-sequencing changed no later-stage quantization"

    ids = jnp.asarray(toks[:, :8], jnp.int32)
    sp = SparsityConfig()
    cache = KVCache.init(cfg, 1, 8, jnp.float32)
    ref, _ = llama.forward(params, ids, cache, 0,
                           llama.zero_thresholds(cfg), cfg=cfg, sp=sp)
    cache = KVCache.init(cfg, 1, 8, jnp.bfloat16)
    got, _ = llama.forward(sub, ids, cache, 0,
                           llama.zero_thresholds(cfg), cfg=cfg, sp=sp)
    rel = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    assert np.isfinite(np.asarray(got)).all()
    assert rel < 0.25, rel

    with pytest.raises(ValueError):
        gptq_quantize_model(params, cfg, toks, group=32,
                            sequential=False, intra_block=True)
