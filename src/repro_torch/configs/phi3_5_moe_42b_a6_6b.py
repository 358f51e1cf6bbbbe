"""phi3.5-moe-42b-a6.6b  [hf:microsoft/Phi-3.5-MoE-instruct]

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""
from repro_torch.config import ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        d_ff_expert=6400,
        vocab_size=32064,
        num_experts=16,
        num_shared_experts=0,
        top_k=2,
        rope_theta=10_000.0,
        param_sharding="fsdp",
    )
