"""SparsifyFn semantics: strict-threshold masking, prefill-half rule,
decode rule (reference `utils/utils.py:32-52`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from teal_jax.config import SparsityConfig
from teal_jax.ops.sparsify import apply_sparsity, sparsify


def test_sparsify_masks_below_and_at_threshold():
    x = jnp.array([[-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]])
    out = sparsify(x, 1.0)
    # strict |x| > t: entries with |x| <= 1.0 are zeroed, including |x| == t
    np.testing.assert_array_equal(
        np.asarray(out), [[-2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 2.0]]
    )


def test_zero_threshold_keeps_nonzeros():
    x = jnp.array([[0.0, -0.1, 0.2]])
    np.testing.assert_array_equal(np.asarray(sparsify(x, 0.0)), np.asarray(x))


def test_decode_always_sparsified():
    cfg = SparsityConfig(enabled=True, apply_prefill=False)
    x = jnp.full((2, 1, 8), 0.5)
    out = apply_sparsity(x, 1.0, cfg)
    assert np.all(np.asarray(out) == 0.0)


def test_prefill_dense_when_apply_prefill_false():
    cfg = SparsityConfig(enabled=True, apply_prefill=False)
    x = jnp.full((2, 6, 8), 0.5)
    out = apply_sparsity(x, 1.0, cfg)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))


def test_prefill_last_half_rule():
    cfg = SparsityConfig(enabled=True, apply_prefill=True,
                         prefill_fraction=0.5)
    x = jnp.full((1, 7, 4), 0.5)
    out = np.asarray(apply_sparsity(x, 1.0, cfg))
    # int(0.5*7) = 3 trailing positions sparsified, 4 leading left dense
    np.testing.assert_array_equal(out[:, :4], np.asarray(x[:, :4]))
    assert np.all(out[:, 4:] == 0.0)


def test_prefill_fraction_knob():
    cfg = SparsityConfig(enabled=True, apply_prefill=True,
                         prefill_fraction=0.99)
    x = jnp.full((1, 100, 4), 0.5)
    out = np.asarray(apply_sparsity(x, 1.0, cfg))
    np.testing.assert_array_equal(out[:, :1], np.asarray(x[:, :1]))
    assert np.all(out[:, 1:] == 0.0)


def test_disabled_is_identity():
    cfg = SparsityConfig(enabled=False)
    x = jnp.full((1, 1, 4), 0.01)
    np.testing.assert_array_equal(
        np.asarray(apply_sparsity(x, 100.0, cfg)), np.asarray(x)
    )


def test_group_sparsify_matches_kernel_selection():
    """Group accuracy-twin rule == the group rule's index-set reference twin."""
    import jax
    from teal_jax.ops.sparsify import (block_sparse_matmul_reference,
                                       sparsify_groups)

    x = jax.random.normal(jax.random.PRNGKey(0), (1, 256), jnp.float32)
    w = jnp.eye(256, dtype=jnp.float32)
    xs = sparsify_groups(x, 16, 0.5)
    ref = block_sparse_matmul_reference(x, w, None, 16, 0.5)
    np.testing.assert_allclose(np.asarray(xs), np.asarray(ref), atol=1e-6)


def test_group_sparsify_keeps_exact_fraction():
    import jax
    from teal_jax.ops.sparsify import sparsify_groups

    x = jax.random.normal(jax.random.PRNGKey(1), (3, 5, 256), jnp.float32)
    out = np.asarray(sparsify_groups(x, 16, 0.5))
    # per position: exactly 8 of 16 groups survive
    zg = (np.abs(out).reshape(3, 5, 16, 16).max(-1) > 0).sum(-1)
    assert np.all(zg == 8)


def test_group_mode_prefill_rule():
    cfg = SparsityConfig(enabled=True, mode="group", block_size=16,
                         block_keep_frac=0.5, apply_prefill=True,
                         prefill_fraction=0.5)
    import jax
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 8, 64), jnp.float32)
    out = np.asarray(apply_sparsity(x, 0.0, cfg))
    np.testing.assert_array_equal(out[:, :4], np.asarray(x[:, :4]))
    assert (out[:, 4:] == 0).sum() > 0
