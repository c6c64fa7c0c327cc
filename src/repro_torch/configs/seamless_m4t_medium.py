"""SeamlessM4T-medium backbone: 12L enc + 12L dec, d=1024 16H ff=4096.

[arXiv:2308.11596; hf] — enc-dec, multimodal; audio frontend is a STUB
(input_specs feeds precomputed frame embeddings per the assignment).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,             # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio_frames",
    embed_scale=True,
    attn=AttnConfig(rope_theta=1e4),
    source="arXiv:2308.11596",
))
