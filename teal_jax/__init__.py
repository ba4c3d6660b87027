"""teal_jax — activation-sparse LLM inference on NVIDIA GPUs, in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
FasterDecoding/TEAL (arXiv 2408.14690): training-free activation sparsity via
magnitude thresholding of the hidden states feeding all seven transformer
projections (q, k, v, o, gate, up, down), with histogram-based threshold
calibration, block-wise greedy per-layer sparsity allocation, a Pallas-Triton
row-skipping sparse-GEMV decode kernel, weight-only quantization, and tensor-parallel
decode over a `jax.sharding.Mesh`.

Unlike the reference (which maintains two stacks: an HF-transformers
monkeypatch stack for accuracy and a gpt-fast fork for speed), teal_jax has a
single functional model implementation; calibration, accuracy eval and fast
decode are the same forward under different jit entry points.
"""

__version__ = "0.1.0"

from teal_jax.config import ModelConfig, SparsityConfig, get_model_config

__all__ = [
    "ModelConfig",
    "SparsityConfig",
    "get_model_config",
    "__version__",
]
