"""whisper-large-v3  [arXiv:2212.04356]

32L d_model=1280 20H (kv=20, i.e. MHA) d_ff=5120 vocab=51866 — enc-dec.
The conv frontend is a STUB per the brief: input_specs() feeds precomputed
frame embeddings (B, 1500, 1280).  "32L" is read as 32 encoder + 32 decoder
layers (the real whisper-large layout); shape seq_len applies to the decoder.
LayerNorm + GELU MLP (not RMSNorm/SwiGLU); learned positions, no RoPE.
vocab padded 51866 -> 51872 for the 16-way vocab-parallel logits.
"""
from repro_torch.config import ModelConfig, register


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        num_layers=32,
        enc_layers=32,
        enc_frames=1500,
        frontend="audio",
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        act="gelu",
        rope_theta=0.0,   # learned absolute positions
        param_sharding="dp",
    )
