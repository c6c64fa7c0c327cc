"""Gemma2-2B: 26L d=2304 8H (kv=4) ff=9216, local/global alternating + softcaps.

[arXiv:2408.00118; hf] — head_dim=256 (independent of d_model), window 4096.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    tie_embeddings=True,
    sandwich_norms=True,
    embed_scale=True,
    attn=AttnConfig(logit_softcap=50.0, final_softcap=30.0,
                    sliding_window=4096, layer_pattern="local_global",
                    rope_theta=1e4),
    source="arXiv:2408.00118",
))
