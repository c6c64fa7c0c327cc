#!/usr/bin/env python3
"""How far float32 rounding moves a training step's gradients at
Qwen2-7B's widths, under the JAX package's initializer and under
``chip_smoke.py``'s ``ranks_fan_in``.

The JAX package draws a "scaled" leaf at std ``scale / sqrt(shape[0])``
(``src/repro/models/params.py:66``), and the port draws it the same way.
For a leaf stacked over the layers, [L, D, ...], ``shape[0]`` is the layer
count, not the fan-in, so at Qwen2-7B's d_model the attention logits come
out thousands wide and every softmax is one-hot.  A step's gradients are
then so badly conditioned that two float32 orders of the same sums (one
rank against a tensor-parallel mesh) cannot agree.

For each initializer this builds Qwen2-7B cut to the ranks phase's 2
layers (float32, random weights from seed 0, one sequence of ``--seq`` tokens
from seed 1), and prints one JSON line:

* ``logit_std``: the std of layer 0's attention logits of head 0 before
  RoPE (a rotation, which keeps their size), q.k / sqrt(head_dim) over
  the normed embeddings of the sequence;
* ``top_prob``: the mean over the causal rows of their largest softmax
  probability (1 is one-hot);
* ``rel``: per leaf, the largest change of its gradient over the
  gradient's largest magnitude when every weight is moved by one float32
  rounding (times 1 + s 2^-23, s = +-1 drawn from seed 2), and ``max_rel``
  and ``min_rel`` over the leaves.

    python3 tools/fan_in_witness.py [--device cuda|cpu] [--seq 1024]
        [--vocab N] [--d-ff N]

The defaults are ``chip_smoke.py``'s ranks phase on a card (Qwen2-7B's
published vocab and d_ff, 1024 tokens).  On the CPU cut the vocab, d_ff
and sequence (``--vocab 2048 --d-ff 512 --seq 256``): the heads and
d_model, which set the logits' size, stay Qwen2-7B's.  Exits non-zero
without a card unless ``--device cpu``.
"""
import argparse
import dataclasses
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def witness(torch, cfg, dev, seq, fan_in):
    from chip_smoke import RANKS_TRAIN_RUN, ranks_fan_in
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import make_loss_fn
    from torch.utils._pytree import (keystr, tree_flatten_with_path,
                                     tree_unflatten)

    model = build_model(cfg, RunConfig(**RANKS_TRAIN_RUN))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    if fan_in:
        ranks_fan_in(torch, params, cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1),
                         generator=torch.Generator(dev).manual_seed(1),
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    loss_fn = make_loss_fn(model)
    named, spec = tree_flatten_with_path(params)

    def grads(flat):
        leaves = [t.detach().requires_grad_() for t in flat]
        loss, _ = loss_fn(tree_unflatten(leaves, spec), batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, leaves, allow_unused=True)

    sign = torch.Generator(dev).manual_seed(2)

    def nudge(t):
        s = torch.randint(0, 2, t.shape, generator=sign, device=dev) * 2 - 1
        return t * (1 + s.to(t.dtype) * 2.0 ** -23)
    flat = [t for _, t in named]
    loss, g = grads(flat)
    _, g2 = grads([nudge(t) for t in flat])
    rel = {keystr(k): float((a - b).abs().max() / a.abs().max())
           for (k, _), a, b in zip(named, g, g2)
           if a is not None and a.abs().max() > 0}

    with torch.no_grad():
        attn = {k: v[0] for k, v in params["layers"]["attn"].items()}
        x = rmsnorm({"scale": params["layers"]["ln_attn"]["scale"][0]},
                    params["embed"][toks[0, :-1].long()], cfg.norm_eps)
        q = x @ attn["wq"][:, 0] + attn["bq"][0]
        k = x @ attn["wk"][:, 0] + attn["bk"][0]
        logits = (q @ k.T) / math.sqrt(q.shape[-1])
        mask = torch.ones(seq, seq, dtype=torch.bool, device=dev).tril()
        top = logits.masked_fill(~mask, -math.inf).softmax(-1).amax(-1)
    return {"init": "ranks_fan_in" if fan_in else "jax", "loss": loss,
            "logit_std": float(logits[mask].std()),
            "top_prob": float(top.mean()),
            "max_rel": max(rel.values()), "min_rel": min(rel.values()),
            "rel": rel}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("fan_in_witness: no CUDA device is available; "
                         "pass --device cpu")
    from chip_smoke import RANKS_LAYERS, RANKS_SEQ
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = get_config("qwen2-7b")
    seq = args.seq or RANKS_SEQ
    cut = {"num_layers": RANKS_LAYERS}
    if args.vocab:
        cut["vocab_size"] = args.vocab
    if args.d_ff:
        cut["d_ff"] = args.d_ff
    cfg = dataclasses.replace(cfg, **cut)
    where = {"device": str(dev), "layers": cfg.num_layers, "seq": seq,
             "d_model": cfg.d_model, "heads": cfg.num_heads,
             "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
             "vocab": cfg.vocab_size, "torch": torch.__version__}
    if dev.type == "cuda":
        import subprocess
        where["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for fan_in in (False, True):
        print(json.dumps({**where, **witness(torch, cfg, dev, seq, fan_in)}),
              flush=True)


if __name__ == "__main__":
    main()
