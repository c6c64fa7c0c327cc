"""Mamba2-780M: 48L d=1536 attention-free, SSD state=128. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_dim=4,
                  chunk_size=256, ngroups=1),
    source="arXiv:2405.21060",
))
