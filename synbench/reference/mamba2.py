"""Mamba-2 (arXiv:2405.21060): the analytic count of its forward's matrix
products.

Per layer: the input projection to z, x, B, C and the step sizes; the SSD
scan in its chunked matrix form (the paper's ``ssd_minimal``), in float32
on the sequence padded to whole chunks: the chunk's C·Bᵀ, those weights
times x, each chunk's state (Bᵀ·x over the chunk) and each position's
read-out of the state entering its chunk; the output projection.  The
convolution, the gates, the norms and the state's decay are element-wise,
not products.  A decode step's only product beside the projections is
the state's read-out, C·state per head; its update is an outer product,
element-wise.  The output head is the embedding, transposed (tied).
"""
from __future__ import annotations

from typing import Dict, List

from synbench.reference.counts import Count, add, product

#: the state has a fixed size, so one decode step costs the same at every
#: position
DECODE_COST_DEPENDS_ON_LENGTH = False


def dims(config: Dict) -> Dict:
    s = config["mamba2_layer"]
    D, E, P = config["d_model"], s["expand"], s["headdim"]
    mult = config["pad_vocab_size_multiple"]
    return {"D": D, "L": config["n_layer"], "N": s["d_state"], "P": P,
            "di": E * D, "H": E * D // P, "G": s["ngroups"],
            "K": s["d_conv"], "chunk": s["chunk_size"],
            "V": -(-config["vocab_size"] // mult) * mult,
            "eps": config["norm_epsilon"], "tied": config["tie_embeddings"]}


def port_fields(config: Dict) -> Dict:
    d = dims(config)
    return {"num_layers": d["L"], "d_model": d["D"], "vocab_size": d["V"],
            "ssm.state_dim": d["N"], "ssm.head_dim": d["P"],
            "ssm.expand": d["di"] // d["D"], "ssm.conv_dim": d["K"],
            "ssm.chunk_size": d["chunk"], "ssm.ngroups": d["G"],
            "norm_eps": d["eps"], "tie_embeddings": d["tied"]}


def _proj_width(d: Dict) -> int:
    return 2 * d["di"] + 2 * d["G"] * d["N"] + d["H"]


def prefill_samples(config: Dict, B: int, S: int, elem: int = 2
                    ) -> List[Count]:
    d = dims(config)
    H, N, P = d["H"], d["N"], d["P"]
    Q = min(d["chunk"], S)
    nc = -(-S // Q)
    bt = B * nc * H                 # one product a (row, chunk, head)
    layer = add(product(B * S, d["D"], _proj_width(d), elem),
                product(Q, N, Q, 4, batch=bt),        # C·Bᵀ
                product(Q, Q, P, 4, batch=bt),        # (weights)·x
                product(N, Q, P, 4, batch=bt),        # chunk states
                product(Q, N, P, 4, batch=bt),        # read-out
                product(B * S, d["di"], d["D"], elem))
    return [(0, 0)] + [layer] * d["L"] + [product(B, d["D"], d["V"], elem)]


def decode_samples(config: Dict, B: int, T: int = 0, elem: int = 2
                   ) -> List[Count]:
    d = dims(config)
    layer = add(product(B, d["D"], _proj_width(d), elem),
                product(1, d["N"], d["P"], 4, batch=B * d["H"]),
                product(B, d["di"], d["D"], elem))
    return [(0, 0)] + [layer] * d["L"] + [product(B, d["D"], d["V"], elem)]
