"""The configurations the port serves (one module per arch, as in the JAX
package's ``configs``): the dense, MoE, SSM, hybrid, encoder-decoder and
VLM families, every configuration of the JAX package's registry."""
from repro_torch.configs import (  # noqa: F401
    internvl2_26b,
    jamba_1_5_large_398b,
    llama3_8b,
    mamba2_1_3b,
    phi3_5_moe_42b_a6_6b,
    qwen2_7b,
    qwen2_moe_a2_7b,
    qwen3_4b,
    whisper_large_v3,
    yi_9b,
)

DENSE_ARCHS = ("qwen2-7b", "qwen3-4b", "llama3-8b", "yi-9b")
MOE_ARCHS = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
SSM_ARCHS = ("mamba2-1.3b",)
HYBRID_ARCHS = ("jamba-1.5-large-398b",)
ENCDEC_ARCHS = ("whisper-large-v3",)
VLM_ARCHS = ("internvl2-26b",)

# the JAX package's training presets (``repro.configs.PERF_PRESETS``), for
# ``get_config(arch, **PERF_PRESETS[arch])``; "ep" runs the expert-parallel
# dispatch under a ``ShardCtx`` with a model axis, the sort dispatch
# without one
PERF_PRESETS = {
    "qwen2-moe-a2.7b": dict(moe_impl="ep", microbatch=16, remat=False),
    "phi3.5-moe-42b-a6.6b": dict(moe_impl="ep", microbatch=16),
    "jamba-1.5-large-398b": dict(moe_impl="ep", microbatch=16),
    "llama3-8b": dict(microbatch=8),
    "yi-9b": dict(microbatch=8),
    "qwen2-7b": dict(microbatch=8),
    "qwen3-4b": dict(microbatch=8),
}
