"""Qwen2-72B: 80L d=8192 64H (kv=8) ff=29568. GQA + QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    attn=AttnConfig(qkv_bias=True, rope_theta=1e6),
    source="arXiv:2407.10671",
))
