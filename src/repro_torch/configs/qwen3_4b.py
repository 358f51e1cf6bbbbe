"""qwen3-4b  [hf:Qwen/Qwen3-8B family]

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936 — qk_norm, GQA,
explicit head_dim=128 (32*128 = 4096 != d_model).
"""
from repro_torch.config import ModelConfig, register


@register("qwen3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        param_sharding="dp",
    )
