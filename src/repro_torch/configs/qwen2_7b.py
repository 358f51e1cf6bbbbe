"""qwen2-7b  [arXiv:2407.10671]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — GQA, QKV bias.
28 heads are not divisible by the 16-way model axis; head-sharded attention
intermediates are padded 28->32 by GSPMD (~14% attention-FLOP padding).
"""
from repro_torch.config import ModelConfig, register


@register("qwen2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        param_sharding="dp",
    )
