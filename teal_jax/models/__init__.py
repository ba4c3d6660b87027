from teal_jax.models import llama

__all__ = ["llama"]
