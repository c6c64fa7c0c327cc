"""Llama-4 Scout 17B-A16E: 48L d=5120 40H (kv=8) MoE 16e top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE, early fusion.
"""
from repro_torch.configs.base import (
    AttnConfig, ModelConfig, MoEConfig, register)

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,                 # shared-expert FFN width
    vocab_size=202048,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
    attn=AttnConfig(rope_theta=5e5),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
