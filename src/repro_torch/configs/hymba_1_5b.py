"""Hymba-1.5B: 32L d=1600 25H (kv=5) ff=5504, parallel attn+mamba heads.

[arXiv:2411.13676; hf] — hybrid heads per layer; 3 full-attention layers
(first/middle/last), sliding window elsewhere; ssm_state=16.
"""
from repro_torch.configs.base import (
    AttnConfig, ModelConfig, SSMConfig, register)

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_dim=4,
                  chunk_size=256, ngroups=1),
    attn=AttnConfig(sliding_window=2048, layer_pattern="hymba", rope_theta=1e4),
    source="arXiv:2411.13676",
))
