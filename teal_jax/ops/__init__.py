from teal_jax.ops.sparsify import sparsify, apply_sparsity
from teal_jax.ops.distribution import (
    Histogram,
    Distribution,
    build_histogram,
    threshold_for_sparsity,
)

__all__ = [
    "sparsify",
    "apply_sparsity",
    "Histogram",
    "Distribution",
    "build_histogram",
    "threshold_for_sparsity",
]
