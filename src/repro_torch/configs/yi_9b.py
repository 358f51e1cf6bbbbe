"""yi-9b  [arXiv:2403.04652]

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 — llama-arch GQA.
"""
from repro_torch.config import ModelConfig, register


@register("yi-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=10_000.0,
        param_sharding="dp",
    )
