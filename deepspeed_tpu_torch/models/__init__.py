from .convert import (cut_leaf, gather_leaf, gather_rank_shards,
                      params_from_jax, params_to_numpy, place_leaf,
                      rank_shard, read_fp32_safetensors,
                      train_state_from_jax)
from .moe import MoETransformerLM
from .presets import (bert, bloom, build_model, gpt2, llama2, mixtral, opt,
                      tiny_test)
from .transformer import TPLayout, TransformerConfig, TransformerLM

__all__ = ["MoETransformerLM", "TPLayout", "TransformerConfig",
           "TransformerLM", "bert", "bloom", "build_model", "cut_leaf",
           "gather_leaf", "gather_rank_shards", "gpt2", "llama2", "mixtral", "opt",
           "params_from_jax", "params_to_numpy", "place_leaf", "rank_shard",
           "read_fp32_safetensors", "tiny_test", "train_state_from_jax"]
