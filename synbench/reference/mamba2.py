"""Mamba-2 (arXiv:2405.21060): the analytic count of its forward's matrix
products and the plain float32 forward.

Per layer: the input projection to z, x, B, C and the step sizes; the SSD
scan in its chunked matrix form (the paper's ``ssd_minimal``), in float32
on the sequence padded to whole chunks: the chunk's C·Bᵀ, those weights
times x, each chunk's state (Bᵀ·x over the chunk) and each position's
read-out of the state entering its chunk; the output projection.  The
convolution, the gates, the norms and the state's decay are element-wise,
not products.  A decode step's only product beside the projections is
the state's read-out, C·state per head; its update is an outer product,
element-wise.  The output head is the embedding, transposed (tied).

The forward is the published block (mamba_ssm's ``Mamba2``) in plain
PyTorch and float32, with the configuration's ``departures`` laid over
it: a pre-norm residual block whose mixer projects to z, x, B, C and the
step sizes; a depthwise causal convolution of width ``d_conv`` with bias
over x, B and C, then SiLU; ``dt = softplus(dt + dt_bias)``, ``A =
-exp(A_log)``; the SSD scan in the chunked form of the paper's
``ssd_minimal`` listing, plus ``D·x``; the gated RMSNorm ``norm(y ·
silu(z))`` over groups of ``d_inner / ngroups`` channels; the output
projection.  Every RMSNorm weight is stored as ``1 + scale``, as the
program stores it.  It runs one row and one layer at a time, upcasting
each layer's weights as it reaches it, so it fits beside them.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from synbench.reference.counts import Count, add, product
# logit_err and shapes_match are this module's too: the runner reads them
from synbench.reference.qwen2 import (fake_fp8, logit_err,  # noqa: F401
                                      shapes_match)

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


def request_flops(config: Dict, prompt: int) -> float:
    """The work one request's prompt needs: the operations of a prefill
    of batch 1 over its length (``prefill_samples``)."""
    return float(sum(f for f, _ in prefill_samples(config, 1, prompt)))


def flash_layers(config: Dict) -> int:
    """Attention-free: a prefill launches no flash kernel."""
    return 0


def weight_shapes(config: Dict) -> Dict:
    """The weight tree the benchmark makes, in the program's layout: the
    stacked layers lead with the layer dim; ``in_proj``'s columns are z,
    x, B, C and dt in that order, the convolution's are x, B and C."""
    d = dims(config)
    D, L, K, H = d["D"], d["L"], d["K"], d["H"]
    ch = d["di"] + 2 * d["G"] * d["N"]
    tree = {"embed": (d["V"], D),
            "layers": {"ln": {"scale": (L, D)},
                       "mamba": {"in_proj": (L, D, _proj_width(d)),
                                 "conv_w": (L, K, ch), "conv_b": (L, ch),
                                 "A_log": (L, H), "dt_bias": (L, H),
                                 "D": (L, H), "norm": (L, d["di"]),
                                 "out_proj": (L, d["di"], D)}},
            "ln_final": {"scale": (D,)}}
    if not d["tied"]:
        tree["lm_head"] = (D, d["V"])
    return tree


#: the spread of each weight that is neither a matrix nor drawn as
#: mamba_ssm draws it (``_DRAWN``)
_SPREAD = {"embed": 0.02, "scale": 0.05, "norm": 0.05, "D": 1.0,
           # nn.Conv1d's bias: one over the square root of three times the
           # fan-in, the width of 4
           "conv_b": 12 ** -0.5}


def _uniform(z: torch.Tensor) -> torch.Tensor:
    """Standard normal draws to uniform ones on (0, 1)."""
    return torch.special.ndtr(z)


def _dt_bias(z: torch.Tensor) -> torch.Tensor:
    """mamba_ssm's ``dt_bias``: the inverse softplus of a step size drawn
    log-uniform from 0.001 to 0.1 (floored at 1e-4)."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + _uniform(z) * (hi - lo)).clamp(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))


def _A_log(z: torch.Tensor) -> torch.Tensor:
    """mamba_ssm's ``A_log``: the log of A drawn uniform from 1 to 16."""
    return torch.log(1.0 + 15.0 * _uniform(z))


#: the weights drawn as mamba_ssm draws them, made from the normal draw:
#: step sizes from 0.001 to 0.1 and decays from 1 to 16, so that dt·A
#: runs from -1.6 to -0.001 and a layer's slowest heads keep their state
#: over thousands of positions, across every chunk's end to a prompt's
#: last position, while its fastest forget it at once
_DRAWN = {"dt_bias": _dt_bias, "A_log": _A_log}


def weight_std(path: tuple, shape: tuple):
    """How each weight is drawn: ``_DRAWN``'s function of the normal draw,
    else a spread: ``_SPREAD``'s by name, and for the projections and
    the convolution mamba_ssm's initialisation: PyTorch's default for
    ``nn.Linear`` and ``nn.Conv1d``, one over the square root of three
    times the fan-in (the convolution's fan-in is its width), and the
    output projection's further over the square root of the depth
    (``_init_weights``'s ``rescale_prenorm_residual``, one residual
    branch a layer).  At one over the square root of the fan-in alone a
    48-layer stack amplifies any rounding so far that a bfloat16 copy of
    this forward and the fp8 control read alike (``PERF.md`` §2)."""
    if path[-1] in _DRAWN:
        return _DRAWN[path[-1]]
    if path[-1] in _SPREAD:
        return _SPREAD[path[-1]]
    if path[0] != "layers":                     # an untied output head
        return shape[0] ** -0.5
    std = (3 * shape[1]) ** -0.5
    return std * shape[0] ** -0.5 if path[-1] == "out_proj" else std


# ---------------------------------------------------------------------------
# the plain float32 forward
# ---------------------------------------------------------------------------

def segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: entry (i, j) is ``x[j+1] + .. + x[i]`` for
    i >= j and -inf above the diagonal (the paper's stable ``segsum``)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    out = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD scan of one row from a zero state, in the chunked form of
    the paper's ``ssd_minimal`` listing, in its inputs' dtype: x [S, H,
    P], dt [S, H],
    A [H], B and C [S, G, N] (head h reads group h // (H / G)).  Returns y
    [S, H, P].  The row is padded with dt = 0 to whole chunks, which
    leaves the state as it is."""
    S, H, P = x.shape
    G = Bm.shape[1]
    pad = -S % chunk
    Q, nc = chunk, (S + pad) // chunk
    X = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad)).view(nc, Q, H, P)
    Ad = F.pad(dt * A, (0, 0, 0, pad)).view(nc, Q, H).permute(2, 0, 1)
    Bh = F.pad(Bm.repeat_interleave(H // G, dim=1),
               (0, 0, 0, 0, 0, pad)).view(nc, Q, H, -1)
    Ch = F.pad(Cm.repeat_interleave(H // G, dim=1),
               (0, 0, 0, 0, 0, pad)).view(nc, Q, H, -1)
    cum = torch.cumsum(Ad, dim=-1)                          # [H, nc, Q]
    # within each chunk
    Lw = torch.exp(segsum(Ad))                              # [H, nc, Q, Q]
    CB = torch.einsum("clhn,cshn->hcls", Ch, Bh)
    y = torch.einsum("hcls,cshp->clhp", CB * Lw, X)
    del CB, Lw
    # each chunk's state, then the states entering each chunk
    decay = torch.exp(cum[..., -1:] - cum)                  # [H, nc, Q]
    states = torch.einsum("clhn,hcl,clhp->chpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:1]), states])
    across = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))  # [H, nc+1, nc+1]
    entering = torch.einsum("hzc,chpn->zhpn", across, states)[:-1]
    # each position's read-out of the state entering its chunk
    y = y + torch.einsum("clhn,chpn,hcl->clhp", Ch, entering, torch.exp(cum))
    return y.reshape(nc * Q, H, P)[:S]


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def _rounded(t: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``t`` rounded to bfloat16 where the control runs (``fp8``): an
    activation the bfloat16 program keeps in bfloat16."""
    return t.to(torch.bfloat16).float() if fp8 else t


def mixer(p: Dict, h: torch.Tensor, d: Dict, *, precision: str = "float32"
          ) -> torch.Tensor:
    """One Mamba-2 mixer over one row ``h`` [S, D] (the block's normed
    input, float32), with one layer's weights ``p``, float32 (``in_proj``
    [D, 2di + 2GN + H], ``conv_w`` [K, di + 2GN], ``conv_b``, ``A_log``,
    ``dt_bias``, ``D`` [H], ``norm`` [di], ``out_proj`` [di, D]) and
    ``dims`` ``d``
    (``di``, ``H``, ``P``, ``N``, ``G``, ``chunk``, ``eps``).  Returns the
    output [S, D], float32.

    ``precision="fp8"`` is the control's: ``in_proj`` and ``out_proj``
    and their inputs rounded to float8 e4m3 (weights by output column,
    inputs by row), and every activation the bfloat16 program keeps in
    bfloat16 rounded to it; the scan stays float32, as the program runs
    it."""
    fp8 = precision == "fp8"
    S = h.shape[0]
    di, H, P, N, G = d["di"], d["H"], d["P"], d["N"], d["G"]

    def act(t):
        return _rounded(t, fp8)

    def mm(x, w):
        if fp8:
            return act(fake_fp8(x, -1) @ fake_fp8(w, 0))
        return x @ w

    z, xBC, dt = torch.split(mm(h, p["in_proj"]), [di, di + 2 * G * N, H],
                             dim=-1)
    w, K = p["conv_w"], p["conv_w"].shape[0]
    xp = F.pad(xBC, (0, 0, K - 1, 0))
    xBC = act(F.silu(sum(xp[i:i + S] * w[i] for i in range(K))
                     + p["conv_b"]))
    x, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.view(S, H, P)
    y = act(ssd(xh, dt, A, Bm.view(S, G, N), Cm.view(S, G, N), d["chunk"])
            + p["D"][:, None] * xh).reshape(S, di)
    g = (y * F.silu(z)).view(S, G, di // G)
    g = act(_rms(g, p["norm"].view(G, di // G), d["eps"]))
    return mm(g.reshape(S, di), p["out_proj"])


def final_hidden(weights: Dict, rows: List[torch.Tensor], config: Dict, *,
                 precision: str = "float32") -> List[torch.Tensor]:
    """The final norm's output [S, D] at every position of each token row
    in ``rows`` (1-D int64 tensors, any lengths), float32, each row from
    a zero state; ``head`` turns it into logits.  ``precision="fp8"`` is
    the control (``mixer``), with the residual stream and the norms'
    outputs rounded to bfloat16 as the program keeps them."""
    d = dims(config)
    fp8 = precision == "fp8"

    def act(t):
        return _rounded(t, fp8)

    dev = weights["embed"].device
    xs = [act(weights["embed"][r.to(dev)].float()) for r in rows]
    lay = weights["layers"]
    for li in range(d["L"]):
        p = {k: v[li].float() for k, v in lay["mamba"].items()}
        s_ln = lay["ln"]["scale"][li].float()
        for i, x in enumerate(xs):
            h = act(_rms(x, s_ln, d["eps"]))
            xs[i] = act(x + mixer(p, h, d, precision=precision))
    s_fin = weights["ln_final"]["scale"].float()
    return [act(_rms(x, s_fin, d["eps"])) for x in xs]


def head(weights: Dict, h: torch.Tensor, config: Dict, *,
         precision: str = "float32") -> torch.Tensor:
    """Logits [..., V] of final hidden states ``h`` [..., D], float32;
    the head is the embedding, transposed, where the configuration ties
    them.  ``precision="fp8"`` rounds the head and ``h`` to float8 e4m3
    first."""
    w = weights["embed"].T if dims(config)["tied"] else weights["lm_head"]
    if precision == "fp8":
        return fake_fp8(h, -1) @ fake_fp8(w.float(), 0)
    return h @ w.float()
