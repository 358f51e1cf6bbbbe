"""Tiny reduced configs (same family wiring, small dims) for CPU tests."""
from __future__ import annotations

from repro_torch.config import ModelConfig, get_config

_TINY_COMMON = dict(remat=False, scan_layers=True, moe_impl="sort",
                    capacity_factor=16.0)


def tiny_config(name: str, **extra) -> ModelConfig:
    """Reduced config of the same family as the full arch ``name``, as the
    JAX package's ``tiny_config`` gives it: two layers, or two periods of a
    hybrid plan."""
    cfg = get_config(name)
    over = dict(
        num_layers=max(2, len_plan(cfg)),
        d_model=64,
        d_ff=128,
        d_ff_expert=96 if cfg.d_ff_expert else 0,
        vocab_size=256,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        num_experts=4 if cfg.num_experts else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_frames=12 if cfg.enc_layers else 1500,
        vision_patches=8 if cfg.family == "vlm" else 1024,
        **_TINY_COMMON,
    )
    over.update(extra)
    return cfg.replace(**over)


def len_plan(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.attn_every * 2  # two periods
    return 2
