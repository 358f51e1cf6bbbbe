"""llama3-8b  [arXiv:2407.21783]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 — GQA, 128k vocab.
vocab padded 128256 -> 128256 (already /16-divisible: 8016 per shard).
"""
from repro_torch.config import ModelConfig, register


@register("llama3-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        param_sharding="dp",
    )
