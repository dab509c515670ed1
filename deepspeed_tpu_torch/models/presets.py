"""Model-family presets (counterpart of ``deepspeed_tpu/models/presets.py``,
dense decoders only)."""

from __future__ import annotations

from .transformer import TransformerConfig, TransformerLM


def gpt2(size: str = "125m", **overrides) -> TransformerConfig:
    table = {
        "125m": dict(n_layer=12, n_head=12, d_model=768),
        "350m": dict(n_layer=24, n_head=16, d_model=1024),
        "774m": dict(n_layer=36, n_head=20, d_model=1280),
        "1.5b": dict(n_layer=48, n_head=25, d_model=1600),
    }
    base = dict(vocab_size=50257, max_seq=1024, pos_embedding="learned",
                norm="layernorm", activation="gelu", use_bias=True,
                tie_embeddings=True)
    base.update(table[size])
    base.update(overrides)
    return TransformerConfig(**base)


def llama2(size: str = "7b", **overrides) -> TransformerConfig:
    table = {
        "tiny": dict(n_layer=4, n_head=8, n_kv_head=4, d_model=256, d_ff=688),
        "7b": dict(n_layer=32, n_head=32, d_model=4096, d_ff=11008),
        "13b": dict(n_layer=40, n_head=40, d_model=5120, d_ff=13824),
        "70b": dict(n_layer=80, n_head=64, n_kv_head=8, d_model=8192, d_ff=28672),
    }
    base = dict(vocab_size=32000, max_seq=4096, pos_embedding="rope",
                norm="rmsnorm", activation="silu_glu", use_bias=False,
                tie_embeddings=False)
    base.update(table[size])
    base.update(overrides)
    return TransformerConfig(**base)


def opt(size: str = "125m", **overrides) -> TransformerConfig:
    """OPT family: learned positions and a ReLU FFN."""
    table = {
        "tiny": dict(n_layer=2, n_head=4, d_model=64, d_ff=256, max_seq=64),
        "125m": dict(n_layer=12, n_head=12, d_model=768),
        "1.3b": dict(n_layer=24, n_head=32, d_model=2048),
        "6.7b": dict(n_layer=32, n_head=32, d_model=4096),
        "13b": dict(n_layer=40, n_head=40, d_model=5120),
    }
    base = dict(vocab_size=50272, max_seq=2048, pos_embedding="learned",
                norm="layernorm", activation="relu", use_bias=True,
                tie_embeddings=True)
    base.update(table[size])
    base.update(overrides)
    return TransformerConfig(**base)


def bloom(size: str = "560m", **overrides) -> TransformerConfig:
    """Bloom family: ALiBi position bias, no positional table."""
    table = {
        "tiny": dict(n_layer=2, n_head=4, d_model=64, d_ff=256, max_seq=64),
        "560m": dict(n_layer=24, n_head=16, d_model=1024),
        "7b": dict(n_layer=30, n_head=32, d_model=4096),
        "176b": dict(n_layer=70, n_head=112, d_model=14336),
    }
    base = dict(vocab_size=250880, max_seq=2048, pos_embedding="alibi",
                norm="layernorm", activation="gelu", use_bias=True,
                tie_embeddings=True)
    base.update(table[size])
    base.update(overrides)
    return TransformerConfig(**base)


def tiny_test(**overrides) -> TransformerConfig:
    """Unit-test sized config."""
    base = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, d_ff=128,
                max_seq=64, tie_embeddings=True)
    base.update(overrides)
    return TransformerConfig(**base)


def build_model(cfg: TransformerConfig) -> TransformerLM:
    """Dense decoders only; MoE and T5 trunks raise (ROADMAP.md queue 1)."""
    if not isinstance(cfg, TransformerConfig):
        raise NotImplementedError(
            f"deepspeed_tpu_torch builds TransformerLM only, got "
            f"{type(cfg).__name__} (ROADMAP.md queue 1, item 10)")
    return TransformerLM(cfg)
