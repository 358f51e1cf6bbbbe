"""internvl2-26b  [arXiv:2404.16821]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 — InternViT + InternLM2.
The InternViT-6B frontend is a STUB per the brief: input_specs() provides
precomputed patch embeddings (B, 1024, d_model) that are concatenated in front
of the token embeddings.  vocab padded 92553 -> 92672 (/16-divisible) for
vocab-parallel logits; padding rows are masked in the loss.
"""
from repro_torch.config import ModelConfig, register


@register("internvl2-26b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        vision_patches=1024,
        frontend="vision",
        rope_theta=1_000_000.0,
        param_sharding="fsdp",
    )
