"""Mixture-of-Experts: token-choice top-k routing with per-group capacity.

The JAX package's gather/scatter dispatch (O(tokens) memory): each batch
row is a routing group; a [B, E, C] token-index table is built by scatter,
tokens are gathered into [B, E, C, D], the expert FFNs run as batched
matrix products, and outputs are combined by a gather back to token order,
weighted by the router gates.  Over-capacity tokens drop (capacity_factor
controls head-room).  Plain PyTorch, as the JAX package's is plain XLA: no
Pallas kernel stands behind it.

The top k come from a stable descending sort, so ties go to the lower
expert index first, as ``jax.lax.top_k`` puts them; ``torch.topk``
promises no order.  A token's place in its expert's buffer is a cumulative
count in slot-major order (token, then its k slots), which decides which
tokens drop, as in the JAX package.

Aux losses: switch load-balance loss and router z-loss, and the share of
dropped (token, slot) pairs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import def_mlp, mlp
from repro_torch.models.params import PDef
from repro_torch.parallel.sharding import shard, shard_local


def def_moe(cfg: ModelConfig) -> Dict[str, Any]:
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.d_ff_expert
    p: Dict[str, Any] = {
        "router": PDef((d, e), ("embed", "experts"), init="scaled", scale=0.1),
        "wi_gate": PDef((e, d, f), ("experts", "embed", "ff"), init="scaled"),
        "wi_up": PDef((e, d, f), ("experts", "embed", "ff"), init="scaled"),
        "wo": PDef((e, f, d), ("experts", "ff", "embed"), init="scaled"),
    }
    if m.shared_expert:
        p["shared"] = def_mlp(d, cfg.d_ff)
    return p


def _capacity(tokens_per_group: int, top_k: int, num_experts: int,
              factor: float) -> int:
    c = int(tokens_per_group * top_k * factor / num_experts)
    return max(c, 1)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router, x, cfg: ModelConfig):
    """Router of ``x`` [B, S, D]: (logits and probs [B,S,E], renormalized
    gates, expert indices, positions in the experts' buffers and the keep
    mask [B,S,K], the one-hot [B,S,K,E]).  Dropped slots' gates are 0."""
    m = cfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    C = _capacity(S, K, E, m.capacity_factor)

    logits = x.float() @ router.float()                      # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, K)                 # [B,S,K]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)       # renormalize

    # --- position within each expert's capacity buffer (per group) ---------
    # ``jax.nn.one_hot``'s comparison: ``F.one_hot`` reads the indices'
    # range first (a sync on a card, and nothing to read on meta tensors)
    oh = (expert_idx[..., None] == torch.arange(
        E, device=expert_idx.device)).long()                 # [B,S,K,E]
    ohf = oh.reshape(B, S * K, E)                            # slot-major order
    pos_in_e = torch.cumsum(ohf, dim=1) - ohf                # [B,S*K,E]
    pos = torch.gather(pos_in_e.reshape(B, S, K, E), -1,
                       expert_idx[..., None])[..., 0]        # [B,S,K]
    keep = pos < C                                           # over-capacity drop
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return logits, probs, gate_vals, expert_idx, pos, keep, oh


def _dispatch(router, x, cfg: ModelConfig):
    """Route ``x`` [B, S, D] and gather each expert's tokens: (gathered
    [B, E, C, D], each (token, slot)'s place in the experts' outputs and
    its gate [B, S, K], and the router's logits, probs, keep mask and
    one-hot for the aux losses)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    C = _capacity(S, K, E, m.capacity_factor)
    logits, probs, gate_vals, expert_idx, pos, keep, oh = _route(
        router, x, cfg)

    # --- dispatch: token index s into [B, E, C+1]; slot C takes the drops,
    # S marks an empty slot.  Kept tokens own distinct slots, so the only
    # repeated writes land in slot C, which the slice discards.
    safe_pos = torch.where(keep, pos, C)
    s_ix = torch.arange(S, device=x.device)[None, :, None].expand(B, S, K)
    table = torch.full((B, E * (C + 1)), S, dtype=torch.long,
                       device=x.device)
    table.scatter_(1, (expert_idx * (C + 1) + safe_pos).reshape(B, S * K),
                   s_ix.reshape(B, S * K))
    table = table.view(B, E, C + 1)[:, :, :C]                # [B,E,C]

    xs = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)       # pad row S
    gathered = torch.gather(
        xs, 1, table.reshape(B, E * C, 1).expand(B, E * C, D)
    ).reshape(B, E, C, D)
    slot = expert_idx * C + torch.clamp(safe_pos, max=C - 1)  # [B,S,K]
    return gathered, slot, gate_vals, (logits, probs, keep, oh)


def _combine(y, slot, gate_vals):
    """Each token's K expert outputs from ``y`` [B, E, C, D], weighted by
    its gates: [B, S, D]."""
    B, E, C, D = y.shape
    S, K = slot.shape[1:]
    flat = y.reshape(B, E * C, D)
    tok_out = torch.gather(
        flat, 1, slot.reshape(B, S * K, 1).expand(B, S * K, D)
    ).reshape(B, S, K, D)
    return (tok_out * gate_vals[..., None].to(y.dtype)).sum(dim=2)


def moe_block(p, x, *, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D], aux losses).  On DTensors the
    routing, dispatch and combine run on each device's rows
    (``shard_local``: DTensor has no layout for their scatters and
    gathers), the expert products on DTensors sharded by expert."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    gathered, slot, gate_vals, stats = shard_local(
        lambda x_, r: _dispatch(r, x_, cfg), x, dims=(0,),
        whole=(p["router"],))
    logits, probs, keep, oh = stats
    gathered = shard(gathered, "batch", "act_experts", "expert_cap", None)

    # --- expert FFN (swiglu): batched matrix products over the experts -----
    wg = p["wi_gate"].to(x.dtype)
    wu = p["wi_up"].to(x.dtype)
    wo = p["wo"].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", gathered, wg)) * \
        torch.einsum("becd,edf->becf", gathered, wu)
    h = shard(h, "batch", "act_experts", "expert_cap", "act_ff")
    y = torch.einsum("becf,efd->becd", h, wo)                # [B,E,C,D]

    # --- combine: gather each token's K expert outputs ----------------------
    out = shard_local(_combine, y, slot, gate_vals, dims=(0,))

    if m.shared_expert:
        out = out + mlp(p["shared"], x)

    # --- aux losses ----------------------------------------------------------
    # Switch load-balance: E * sum_e f_e * p_e  (f: token fraction, p: prob mass)
    density = oh.float().sum(dim=2).mean(dim=(0, 1))         # [E] fraction*K
    prob_mass = probs.mean(dim=(0, 1))                       # [E]
    lb = E * ((density / K) * prob_mass).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()
    aux = {
        "moe_load_balance": m.router_aux_weight * lb,
        "moe_router_z": m.router_z_weight * z,
        "moe_drop_fraction": dropped,
    }
    return out, aux
