from teal_jax.eval.ppl import eval_ppl

__all__ = ["eval_ppl"]
