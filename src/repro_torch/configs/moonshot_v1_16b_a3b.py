"""Moonlight 16B-A3B (kimi/moonshot): 48L d=2048 16H MoE 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import (
    AttnConfig, ModelConfig, MoEConfig, register)

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                    # routed experts only (plus shared)
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, shared_expert=False),
    attn=AttnConfig(rope_theta=5e4),
    source="hf:moonshotai/Moonlight-16B-A3B",
))
