from teal_jax.engine.generate import Generator, GenerateStats

__all__ = ["Generator", "GenerateStats"]
