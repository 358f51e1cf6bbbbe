"""Model configurations of the port: frozen dataclasses and a registry.

A copy of the JAX package's ``ModelConfig``, ``ShapeConfig``,
``TrainConfig``, registry and ``applicable_shapes`` (the port imports
nothing of that package), with the roofline constants of the port's card
(``HardwareConfig``, ``H100_SXM``) where the JAX package has a TPU's.  ``repro_torch.configs``
registers every configuration of the JAX package's registry: the dense,
MoE, SSM, hybrid, encoder-decoder and VLM families.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0       # expert hidden size (0 -> d_ff)
    moe_every: int = 1         # MoE layer every n-th layer (others dense MLP)
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / jamba mamba layers) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0        # hybrid: 1 attention layer per `attn_every` layers

    # --- flavor flags ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    act: str = "silu"          # silu (swiglu) | gelu (plain mlp, whisper)
    tie_embeddings: bool = False

    # --- frontend stubs / enc-dec ---
    frontend: str = "none"     # none | audio | vision
    enc_layers: int = 0        # whisper encoder depth
    enc_frames: int = 1500     # whisper stub frame count
    vision_patches: int = 1024 # internvl stub patch count

    # --- numerics / distribution ---
    dtype: str = "bfloat16"
    param_sharding: str = "fsdp"   # dp | zero1 | fsdp
    remat: bool = True
    remat_policy: str = "full"     # full | dots | offloadable
    microbatch: int = 0            # >1: grad-accumulation microbatches
    decode_f32_scores: bool = True # f32 accumulation in decode attention
    opt_state_dtype: str = "float32"
    moe_impl: str = "sort"     # sort (GSPMD) | ep (shard_map all_to_all) | dense (tiny/tests)
    attn_impl: str = "xla"     # xla | pallas (TPU only)
    scan_layers: bool = True
    attn_block_q: int = 256    # query-block size for the chunked XLA attention
    loss_chunk: int = 512      # seq-chunk size for vocab-sharded cross-entropy

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        """Encoder-only archs have no decode step.  All ten assigned archs decode."""
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_counts(self) -> Dict[str, float]:
        """Return dict with total and active parameter counts (embedding incl.)."""
        D = self.d_model
        hd = self.resolved_head_dim()
        H, K = self.num_heads, self.num_kv_heads
        attn = D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D
        if self.act == "silu":
            dense_mlp = 3 * D * self.d_ff
        else:
            dense_mlp = 2 * D * self.d_ff
        ffe = self.d_ff_expert or self.d_ff
        expert = 3 * D * ffe
        moe_mlp = self.num_experts * expert + self.num_shared_experts * expert + D * self.num_experts
        moe_active = (self.top_k + self.num_shared_experts) * expert + D * self.num_experts
        # mamba2 block params
        din, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
        mamba = D * (2 * din + 2 * N + Hs) + din * D + self.ssm_conv * (din + 2 * N) + 2 * Hs

        total = lay_active = 0.0
        for i in range(self.num_layers):
            if self.family in ("ssm",):
                total += mamba
                lay_active += mamba
                continue
            is_attn = True
            if self.family == "hybrid":
                is_attn = (self.attn_every > 0 and i % self.attn_every == 0)
            mixer = attn if is_attn else mamba
            if self.family in ("moe", "hybrid") and self.num_experts and ((i + 1) % self.moe_every == 0):
                total += mixer + moe_mlp
                lay_active += mixer + moe_active
            elif self.family in ("moe", "hybrid") and self.family == "moe" and self.num_experts:
                total += mixer + moe_mlp
                lay_active += mixer + moe_active
            else:
                total += mixer + dense_mlp
                lay_active += mixer + dense_mlp
        if self.family == "encdec":
            # encoder layers: self-attn + mlp;  decoder (num_layers) adds cross-attn
            total += self.enc_layers * (attn + dense_mlp)
            lay_active += self.enc_layers * (attn + dense_mlp)
            total += self.num_layers * attn  # cross attention
            lay_active += self.num_layers * attn
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return {"total": total + emb, "active": lay_active + emb}


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class HardwareConfig:
    """Roofline constants of one card: NVIDIA H100 SXM (NVIDIA's data
    sheet, dense rates without sparsity, at the full 700 W power limit).
    ``ici_bw`` holds the card's link rate to the other cards of its host:
    NVLink, 900 GB/s all to all, 450 GB/s each way."""
    name: str = "h100_sxm"
    peak_flops: float = 989e12       # bf16 FLOP/s on the tensor cores
    hbm_bw: float = 3.35e12          # bytes/s
    ici_bw: float = 450e9            # bytes/s each way (NVLink)
    hbm_bytes: float = 80e9          # capacity


H100_SXM = HardwareConfig()


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    microbatch: int = 0              # 0 = no accumulation
    grad_compression: str = "none"   # none | int8
    checkpoint_every: int = 50
    label_smoothing: float = 0.0


# --------------------------------------------------------------------------
# registry
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return cfg.replace(**overrides) if overrides else cfg


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the four assigned shapes apply to this arch (brief rules)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.has_decoder():
        out.append("decode_32k")
        if cfg.is_subquadratic():
            out.append("long_500k")
    return tuple(out)
