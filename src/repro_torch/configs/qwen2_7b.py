"""Qwen2-7B: 28L d=3584 28H (kv=4) ff=18944. GQA + QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attn=AttnConfig(qkv_bias=True, rope_theta=1e6),
    source="arXiv:2407.10671",
))
