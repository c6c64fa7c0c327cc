"""Qwen2-VL-2B backbone: 28L d=1536 12H (kv=2) ff=8960, M-RoPE.

[arXiv:2409.12191; hf] — vision frontend is a STUB (precomputed patch
embeddings + 3-stream M-RoPE position ids via input_specs).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    tie_embeddings=True,
    frontend="vision_patches",
    attn=AttnConfig(qkv_bias=True, rope_theta=1e6,
                    mrope_sections=(16, 24, 24)),   # t/h/w splits of head_dim/2
    source="arXiv:2409.12191",
))
