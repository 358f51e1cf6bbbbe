"""jamba-1.5-large-398b  [arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Hybrid Mamba+attention with a 1:7 attn:mamba interleave (layer i is attention
iff i % 8 == 0 -> 9 attention layers / 63 mamba layers), MoE every 2nd layer.
Mamba d_state=128 assumed (brief gives none; mirrors the mamba2 entry).
"""
from repro_torch.config import ModelConfig, register


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        d_ff_expert=24576,
        vocab_size=65536,
        num_experts=16,
        top_k=2,
        moe_every=2,
        attn_every=8,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=128,
        rope_theta=10_000.0,
        param_sharding="fsdp",
        opt_state_dtype="bfloat16",
    )
