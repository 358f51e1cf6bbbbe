"""The configurations the port serves (one module per arch, as in the JAX
package's ``configs``): the dense family and the MoE family.  The hybrid,
SSM, encoder-decoder and VLM configurations are not registered here: their
model families are not ported yet (ROADMAP.md)."""
from repro_torch.configs import (  # noqa: F401
    llama3_8b,
    phi3_5_moe_42b_a6_6b,
    qwen2_7b,
    qwen2_moe_a2_7b,
    qwen3_4b,
    yi_9b,
)

DENSE_ARCHS = ("qwen2-7b", "qwen3-4b", "llama3-8b", "yi-9b")
MOE_ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
