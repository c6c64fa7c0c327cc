"""Qwen2 (arXiv:2407.10671): the analytic count of its forward's matrix
products and the plain float32 forward.

The count follows the model's equations at the shapes a step runs: per
layer the q, k, v and o projections (bias added apart), the attention's
two products and the SwiGLU's three; the output head on the rows whose
logits are taken.  Activations are ``elem`` bytes (bfloat16: 2); dense
attention forms its scores in float32 from upcast q and k, then multiplies
probabilities in the value's dtype, as the program's dense path states.

The forward is the published architecture in plain PyTorch and float32:
RMSNorm (the weight stored as ``1 + scale``), rotary embeddings on the
two halves of each head, causal grouped-query attention with q/k/v
biases, SwiGLU, a final norm and an untied output head.  It takes the
weights the benchmark made, in the layout the benchmark handed the
program, and upcasts each layer's as it reaches it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from synbench.reference.counts import Count, add, product

#: a decode step attends over the whole cache, so its cost depends on the
#: cache's length
DECODE_COST_DEPENDS_ON_LENGTH = True


def dims(config: Dict) -> Dict:
    D, hq = config["hidden_size"], config["num_attention_heads"]
    return {"D": D, "F": config["intermediate_size"],
            "L": config["num_hidden_layers"], "hq": hq,
            "hk": config["num_key_value_heads"], "hd": D // hq,
            "V": config["vocab_size"], "eps": config["rms_norm_eps"],
            "theta": config["rope_theta"],
            "tied": config["tie_word_embeddings"]}


def port_fields(config: Dict) -> Dict:
    """The program's configuration fields this file fixes, by attribute
    path."""
    d = dims(config)
    return {"num_layers": d["L"], "d_model": d["D"], "num_heads": d["hq"],
            "num_kv_heads": d["hk"], "head_dim": d["hd"], "d_ff": d["F"],
            "vocab_size": d["V"], "norm_eps": d["eps"],
            "attn.rope_theta": d["theta"], "attn.qkv_bias": True,
            "tie_embeddings": d["tied"]}


def _layer_linear(d: Dict, M: int, elem: int) -> Count:
    D, F, hq, hk, hd = d["D"], d["F"], d["hq"], d["hk"], d["hd"]
    return add(product(M, D, hq * hd, elem), product(M, D, hk * hd, elem),
               product(M, D, hk * hd, elem), product(M, hq * hd, D, elem),
               product(M, D, F, elem), product(M, D, F, elem),
               product(M, F, D, elem))


def prefill_samples(config: Dict, B: int, S: int, elem: int = 2
                    ) -> List[Count]:
    """(flops, bytes) of the products of each sample of a prefill of B x S
    tokens under dense attention: the glue before the layers (none), each
    layer, and the glue after them (the output head on the last row)."""
    d = dims(config)
    hq, hk, hd = d["hq"], d["hk"], d["hd"]
    # scores: B*hk batches of [G*S, hd] x [hd, S] in float32; then the
    # probabilities [G*S, S] times v [S, hd] in the value's dtype
    scores = product(hq // hk * S, hd, S, 4, batch=B * hk)
    pv = product(hq // hk * S, S, hd, elem, batch=B * hk)
    layer = add(_layer_linear(d, B * S, elem), scores, pv)
    return [(0, 0)] + [layer] * d["L"] + [product(B, d["D"], d["V"], elem)]


def decode_samples(config: Dict, B: int, T: int, elem: int = 2
                   ) -> List[Count]:
    """The same for one decode step of B rows against a cache of T
    positions, which it attends over whole."""
    d = dims(config)
    hq, hk, hd = d["hq"], d["hk"], d["hd"]
    scores = product(hq // hk, hd, T, 4, batch=B * hk)
    pv = product(hq // hk, T, hd, elem, batch=B * hk)
    layer = add(_layer_linear(d, B, elem), scores, pv)
    return [(0, 0)] + [layer] * d["L"] + [product(B, d["D"], d["V"], elem)]


def request_flops(config: Dict, prompt: int) -> float:
    """The work one request's prompt needs: the linear layers over its
    tokens, causal attention over its own length (4 hd operations a
    visible pair and head) and the output head on its last row."""
    d = dims(config)
    lin = _layer_linear(d, prompt, 2)[0]
    attn = 4 * d["hd"] * d["hq"] * prompt * (prompt + 1) // 2
    return float(d["L"] * (lin + attn) + 2 * d["D"] * d["V"])


def flash_layers(config: Dict) -> int:
    """The flash launches of one prefill: one a layer."""
    return dims(config)["L"]


def flash_launch(config: Dict, B: int, S: int, elem: int = 2) -> Count:
    """One causal attention launch over B x S tokens: 4 hd operations a
    visible (query, key) pair and query head; q, k, v and the output read
    or written once."""
    d = dims(config)
    hq, hk, hd = d["hq"], d["hk"], d["hd"]
    flops = 4 * hd * B * hq * S * (S + 1) // 2
    nbytes = elem * (2 * B * hq * S * hd + 2 * B * hk * S * hd)
    return flops, nbytes


# ---------------------------------------------------------------------------
# the plain float32 forward
# ---------------------------------------------------------------------------

def fake_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude to 448), back in float32: the control's
    lower precision."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = 448.0 / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def final_hidden(weights: Dict, rows: List[torch.Tensor], config: Dict, *,
                 precision: str = "float32", q_block: int = 1024
                 ) -> List[torch.Tensor]:
    """The final norm's output [S, D] at every position of each token row
    in ``rows`` (1-D int64 tensors, any lengths), float32; ``head`` turns
    it into logits.

    ``precision="fp8"`` is the control: the serving precision with its
    products one step down, as an fp8 serving path would run them.  Every
    weight matrix (by output column), every product's input activations
    (by row) and attention's q, k, v and probabilities (by row) are
    rounded to float8 e4m3, and every activation the bfloat16 program
    keeps in bfloat16 (the residual stream, norm outputs, projections,
    attention's output, the SwiGLU) is rounded to bfloat16."""
    d = dims(config)
    D, L, hq, hk, hd = d["D"], d["L"], d["hq"], d["hk"], d["hd"]
    G, eps = hq // hk, d["eps"]
    dev = weights["embed"].device
    fp8 = precision == "fp8"

    def w32(t, in_dim=0):
        t = t.float()
        return fake_fp8(t, in_dim) if fp8 else t

    def mm(x, w):
        return act((fake_fp8(x, -1) if fp8 else x) @ w)

    def act(t):
        return t.to(torch.bfloat16).float() if fp8 else t

    def q8(t):
        return fake_fp8(t, -1) if fp8 else t

    freqs = 1.0 / (d["theta"] ** (torch.arange(0, hd // 2, dtype=torch.float32,
                                                 device=dev) / (hd // 2)))
    xs = [weights["embed"][r.to(dev)].float() for r in rows]
    lay = weights["layers"]
    for li in range(L):
        a, m = lay["attn"], lay["mlp"]
        wq = w32(a["wq"][li].reshape(D, hq * hd))
        wk = w32(a["wk"][li].reshape(D, hk * hd))
        wv = w32(a["wv"][li].reshape(D, hk * hd))
        wo = w32(a["wo"][li].reshape(hq * hd, D))
        bq, bk, bv = (a[k][li].float().reshape(-1) for k in ("bq", "bk",
                                                             "bv"))
        wg, wu, wd = w32(m["wi_gate"][li]), w32(m["wi_up"][li]), \
            w32(m["wo"][li])
        s_attn = lay["ln_attn"]["scale"][li].float()
        s_mlp = lay["ln_mlp"]["scale"][li].float()
        for i, x in enumerate(xs):
            S = x.shape[0]
            ang = torch.arange(S, dtype=torch.float32, device=dev)[:, None] \
                * freqs
            cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
            h = act(_rms(x, s_attn, eps))
            q = act(_rope(act(mm(h, wq) + bq).view(S, hq, hd), cos, sin))
            k = act(_rope(act(mm(h, wk) + bk).view(S, hk, hd), cos, sin))
            v = act(mm(h, wv) + bv).view(S, hk, hd)
            # query head j reads kv head j // G
            kh = q8(k.repeat_interleave(G, dim=1).transpose(0, 1))
            vh = q8(v.repeat_interleave(G, dim=1).transpose(0, 1))
            qh = q8(q.transpose(0, 1))                       # [hq,S,hd]
            out = torch.empty_like(qh)
            for q0 in range(0, S, q_block):
                q1 = min(S, q0 + q_block)
                sc = (qh[:, q0:q1] @ kh[:, :q1].transpose(1, 2)) * hd ** -0.5
                qi = torch.arange(q0, q1, device=dev)[:, None]
                ki = torch.arange(q1, device=dev)[None, :]
                sc = sc.masked_fill(ki > qi, float("-inf"))
                out[:, q0:q1] = q8(torch.softmax(sc, dim=-1)) @ vh[:, :q1]
            x = act(x + mm(act(out.transpose(0, 1)).reshape(S, hq * hd), wo))
            h = act(_rms(x, s_mlp, eps))
            x = act(x + mm(act(torch.nn.functional.silu(mm(h, wg))
                               * mm(h, wu)), wd))
            xs[i] = x
        del wq, wk, wv, wo, wg, wu, wd
    s_fin = weights["ln_final"]["scale"].float()
    return [act(_rms(x, s_fin, eps)) for x in xs]


def head(weights: Dict, h: torch.Tensor, config: Dict, *,
         precision: str = "float32") -> torch.Tensor:
    """Logits [..., V] of final hidden states ``h`` [..., D], float32;
    ``precision="fp8"`` rounds the head and ``h`` to float8 e4m3 first."""
    w = weights["embed"].T if dims(config)["tied"] else weights["lm_head"]
    if precision == "fp8":
        return fake_fp8(h, -1) @ fake_fp8(w.float(), 0)
    return h @ w.float()


def weight_shapes(config: Dict) -> Dict:
    """The weight tree the benchmark makes, in the program's layout: the
    stacked layers lead with the layer dim."""
    d = dims(config)
    D, F, L, hq, hk, hd, V = (d[k] for k in ("D", "F", "L", "hq", "hk",
                                               "hd", "V"))
    tree = {"embed": (V, D),
            "layers": {"ln_attn": {"scale": (L, D)},
                       "ln_mlp": {"scale": (L, D)},
                       "attn": {"wq": (L, D, hq, hd), "wk": (L, D, hk, hd),
                                "wv": (L, D, hk, hd), "wo": (L, hq, hd, D),
                                "bq": (L, hq, hd), "bk": (L, hk, hd),
                                "bv": (L, hk, hd)},
                       "mlp": {"wi_gate": (L, D, F), "wi_up": (L, D, F),
                               "wo": (L, F, D)}},
            "ln_final": {"scale": (D,)}}
    if not d["tied"]:
        tree["lm_head"] = (D, V)
    return tree


def weight_std(path: tuple, shape: tuple) -> float:
    """The spread each weight is drawn with: 0.02 for the embedding, 0.05
    for norm scales and biases, and one over the square root of the
    fan-in for a matrix (the attention output's fan-in is its heads times
    the head size)."""
    if path[-1] == "embed":
        return 0.02
    if path[-1] in ("scale", "bq", "bk", "bv"):
        return 0.05
    if path[0] != "layers":
        return shape[0] ** -0.5
    if path[1:] == ("attn", "wo"):
        return (shape[1] * shape[2]) ** -0.5
    return shape[1] ** -0.5


def logit_err(got: torch.Tensor, ref_logits: torch.Tensor) -> List[float]:
    """Per row of ``got`` [k, V] (any float dtype): the largest gap
    between its logits and the reference's [k, V], over the standard
    deviation of the reference's row."""
    ref = ref_logits.float()
    diff = (got.to(ref.device).float() - ref).abs().amax(dim=-1)
    return (diff / ref.std(dim=-1)).tolist()


def shapes_match(tree: Dict, shapes: Dict, path=()) -> Optional[str]:
    """None if ``tree``'s tensors have ``shapes``, else the first path
    that differs."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            return "/".join(path) or "root"
        for k in shapes:
            bad = shapes_match(tree[k], shapes[k], path + (k,))
            if bad:
                return bad
        return None
    return None if tuple(tree.shape) == tuple(shapes) else "/".join(path)
