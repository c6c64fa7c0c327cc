"""Configuration system: model architectures, input shapes, run settings.

Every assigned architecture is a frozen ``ModelConfig``; every assigned input
shape is a ``ShapeConfig``.  The cross product (minus documented skips) is the
40-cell dry-run/roofline matrix.  Configs are plain frozen dataclasses so they
hash, compare, and serialize trivially (the Synapse profile store keys off
them as "tags", mirroring the paper's command+tag indexing).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False          # llama4 has a shared expert alongside routed
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) settings."""
    state_dim: int = 128                 # N
    head_dim: int = 64                   # P
    expand: int = 2                      # d_inner = expand * d_model
    conv_dim: int = 4                    # depthwise causal conv width
    chunk_size: int = 256                # SSD chunk length (matmul form)
    ngroups: int = 1                     # B/C groups


@dataclass(frozen=True)
class AttnConfig:
    qkv_bias: bool = False               # qwen2 family uses bias on qkv
    logit_softcap: Optional[float] = None  # gemma2: 50.0 on attn logits
    final_softcap: Optional[float] = None  # gemma2: 30.0 on lm logits
    sliding_window: Optional[int] = None   # local attention window (tokens)
    # layer_pattern: 'global' | 'local_global' (alternating, gemma2)
    #                | 'hymba' (3 global layers, rest sliding window)
    layer_pattern: str = "global"
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                       # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int                            # dense FFN width (0 if pure MoE / ssm)
    vocab_size: int
    head_dim: int = 128
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn: AttnConfig = field(default_factory=AttnConfig)
    tie_embeddings: bool = False
    sandwich_norms: bool = False         # gemma2: post-attn/post-ffn extra norms
    embed_scale: bool = False            # gemma2/seamless: x *= sqrt(d_model)
    norm_eps: float = 1e-6
    # enc-dec only:
    num_encoder_layers: int = 0
    # modality frontend stub: 'none' | 'audio_frames' | 'vision_patches'
    frontend: str = "none"
    source: str = ""                     # provenance tag from the assignment

    # ---- derived ----------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode over very long context is linear-ish (long_500k gate)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops accounting)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d                                    # embedding
        if not self.tie_embeddings:
            total += V * d                               # lm head
        per_layer = 0
        if self.family != "ssm":
            # attention
            hq, hk, hd = self.num_heads, self.num_kv_heads, self.head_dim
            per_layer += d * hq * hd + 2 * d * hk * hd + hq * hd * d
            if self.attn.qkv_bias:
                per_layer += (hq + 2 * hk) * hd
        if self.ssm is not None:
            di, N, P = self.d_inner, self.ssm.state_dim, self.ssm.head_dim
            nh, G = self.ssm_heads, self.ssm.ngroups
            # in_proj -> [z, x, B, C, dt], conv over (x,B,C), out_proj
            per_layer += d * (2 * di + 2 * G * N + nh)
            per_layer += (di + 2 * G * N) * self.ssm.conv_dim
            per_layer += di * d + nh + nh  # out_proj, A_log, D
        if self.moe is not None:
            e, f = self.moe.num_experts, self.moe.d_ff_expert
            per_layer += d * e                            # router
            per_layer += e * (3 * d * f)                  # gate/up/down per expert
            if self.moe.shared_expert:
                per_layer += 3 * d * self.d_ff
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff                # swiglu
        per_layer += 2 * d                                # norms
        total += L * per_layer
        if self.num_encoder_layers:
            # encoder layers: self-attn + mlp; decoder layers already counted,
            # add cross-attention for decoder layers
            hq, hk, hd = self.num_heads, self.num_kv_heads, self.head_dim
            enc_layer = (d * hq * hd + 2 * d * hk * hd + hq * hd * d
                         + 3 * d * self.d_ff + 2 * d)
            total += self.num_encoder_layers * enc_layer
            cross = d * hq * hd + 2 * d * hk * hd + hq * hd * d + d
            total += L * cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k routed + shared)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        e, k, f = self.moe.num_experts, self.moe.top_k, self.moe.d_ff_expert
        inactive_experts_per_layer = (e - k) * (3 * d * f)
        return self.param_count() - L * inactive_experts_per_layer

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k gate per the assignment + DESIGN.md §4."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        if cfg.name == "gemma2-2b":
            return False, "alternating local/global: global layers are full attention (not sub-quadratic)"
        if cfg.family == "encdec":
            return False, "enc-dec: quadratic encoder self-attention over 512k source frames"
        return False, "pure full-attention arch: long_500k requires sub-quadratic attention"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # Import every config module once, which registers its arch.
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        llama4_scout_17b_a16e, moonshot_v1_16b_a3b, qwen2_7b, qwen2_72b,
        gemma2_2b, qwen2_1_5b, seamless_m4t_medium, qwen2_vl_2b,
        mamba2_780m, hymba_1_5b,
    )


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (per the assignment)."""
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=2,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(2, cfg.num_kv_heads) if cfg.num_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.num_heads else cfg.head_dim,
        attn=dataclasses.replace(
            cfg.attn,
            sliding_window=8 if cfg.attn.sliding_window else None,
            mrope_sections=(2, 3, 3) if cfg.attn.mrope_sections else None,
        ),
        tie_embeddings=cfg.tie_embeddings,
        num_encoder_layers=2 if cfg.num_encoder_layers else 0,
        frontend=cfg.frontend,
        source="smoke",
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(num_experts=4, top_k=min(2, cfg.moe.top_k),
                              d_ff_expert=64, shared_expert=cfg.moe.shared_expert,
                              capacity_factor=2.0)
        kw["d_ff"] = 128 if cfg.moe.shared_expert else 0
    if cfg.ssm:
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                              conv_dim=4, chunk_size=8, ngroups=1)
    return ModelConfig(**kw)
