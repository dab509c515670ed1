from .convert import params_from_jax, params_to_numpy
from .presets import bert, bloom, build_model, gpt2, llama2, opt, tiny_test
from .transformer import TransformerConfig, TransformerLM

__all__ = ["TransformerConfig", "TransformerLM", "bert", "bloom", "build_model",
           "gpt2", "llama2", "opt", "params_from_jax", "params_to_numpy",
           "tiny_test"]
