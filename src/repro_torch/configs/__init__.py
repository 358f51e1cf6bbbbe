"""The dense configurations the port serves (one module per arch, as in the
JAX package's ``configs``).  The MoE, hybrid, SSM, encoder-decoder and VLM
configurations are not registered here: their model families are not
ported yet (ROADMAP.md)."""
from repro_torch.configs import (  # noqa: F401
    llama3_8b,
    qwen2_7b,
    qwen3_4b,
    yi_9b,
)

DENSE_ARCHS = ("qwen2-7b", "qwen3-4b", "llama3-8b", "yi-9b")
