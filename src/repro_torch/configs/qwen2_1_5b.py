"""Qwen2-1.5B: 28L d=1536 12H (kv=2) ff=8960. GQA + QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    tie_embeddings=True,
    attn=AttnConfig(qkv_bias=True, rope_theta=1e6),
    source="arXiv:2407.10671",
))
