from .convert import params_from_jax
from .presets import bloom, build_model, gpt2, llama2, opt, tiny_test
from .transformer import TransformerConfig, TransformerLM

__all__ = ["TransformerConfig", "TransformerLM", "bloom", "build_model",
           "gpt2", "llama2", "opt", "params_from_jax", "tiny_test"]
