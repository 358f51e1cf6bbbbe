"""qwen2-moe-a2.7b  [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60 routed top-4
+ 4 shared experts (HF fuses the shared expert as one 5632-wide MLP; we model
it as 4 x 1408 experts, FLOP- and param-equivalent).
60 experts are padded to 64 on the 16-way `model` axis for expert parallelism.
"""
from repro_torch.config import ModelConfig, register


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5632,            # shared-expert path width (4 x 1408)
        d_ff_expert=1408,
        vocab_size=151936,
        num_experts=60,
        num_shared_experts=4,
        top_k=4,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        param_sharding="fsdp",
    )
