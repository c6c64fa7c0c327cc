#!/usr/bin/env python3
"""Show the MoE router's gradient on a data-parallel mesh of CPU ranks
against one device.

The reduced Moonlight config (``reduced_config``), its state drawn from
seed 0, takes one float32 train step on one device with plain tensors and
on a (2, 1) ``("data", "model")`` mesh of two gloo CPU ranks
(``launch.world.spawn``); prints one JSON line: the largest magnitude of
the router's gradient on one device and the largest difference of rank
0's whole gradient from it, absolute and over that magnitude.  The
routing runs on each rank's rows (``sharding.shard_local``), every rank
reading the router whole (an ``Along`` of no dim), so its gradient is a
sum over the ranks: a gradient that held only one rank's rows would show
as a difference near the share of the other rank's (``relative`` 0.605),
the sum as the float32 floor.

    python3 tools/moe_router_grad_witness.py [--store DIR]
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

RUN = dict(param_dtype="float32", compute_dtype="float32", remat="none",
           loss_chunk=0)
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=100, weight_decay=0.0)


def router_grad(mesh, state_np, batch_np):
    """The router's gradient of one train step, whole (rank 0's view on
    a mesh), as numpy."""
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import RunConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import place, train_state_from_numpy
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import TRAIN_RULES, make_rules
    from repro_torch.train import step as step_mod

    model = build_model(reduced_config(get_config("moonshot-v1-16b-a3b")),
                        RunConfig(**RUN))
    state = train_state_from_numpy(state_np, device="cpu")
    if mesh is not None:
        state = place(state, mesh, step_mod.train_state_specs(
            model, mesh, make_rules(mesh, TRAIN_RULES)))
    got = {}
    update = step_mod.adamw_update

    def capture(g, *a, **kw):
        got["g"] = g
        return update(g, *a, **kw)
    step_mod.adamw_update = capture
    try:
        step_mod.make_train_step(model, OptConfig(**OPT), mesh)(
            state, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    finally:
        step_mod.adamw_update = update
    g = got["g"]["layers"]["moe"]["router"]
    return (g.full_tensor() if mesh is not None else g).detach().numpy()


def rank_fn(rank, state_np, batch_np):
    from repro_torch.launch import world
    return router_grad(world.device_mesh((2, 1), ("data", "model"), "cpu"),
                       state_np, batch_np)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None,
                    help="the ranks' FileStore directory (default: a "
                         "fresh temporary one)")
    args = ap.parse_args()
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.run import RunConfig
    from repro_torch.launch import world
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.params import map_tensors
    from repro_torch.train.step import init_train_state

    model = build_model(reduced_config(get_config("moonshot-v1-16b-a3b")),
                        RunConfig(**RUN))
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    state_np = map_tensors(state, lambda t: t.detach().numpy())
    seq = np.random.default_rng(0).integers(0, 256, (4, 17)) \
        .astype(np.int32)
    batch = {"tokens": seq[:, :-1].copy(), "targets": seq[:, 1:].copy()}
    one = router_grad(None, state_np, batch)
    store = args.store or tempfile.mkdtemp(prefix="router_grad")
    two = world.spawn(rank_fn, 2, state_np, batch, store=store,
                      device="cpu", timeout=300)
    diff = float(np.abs(two - one).max())
    print(json.dumps({"one_device_max": float(np.abs(one).max()),
                      "two_ranks_max_diff": diff,
                      "relative": diff / float(np.abs(one).max())}))


if __name__ == "__main__":
    main()
