"""mamba2-1.3b  [arXiv:2405.21060]

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128 — SSD
(state-space duality).  d_inner = 2*d_model = 4096, 64 heads x headdim 64,
causal depthwise conv k=4, chunked SSD scan (chunk=128).
vocab padded 50280 -> 50304 (a multiple of 128) for the logits.
"""
from repro_torch.config import ModelConfig, register


@register("mamba2-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        tie_embeddings=True,
        param_sharding="dp",
    )
