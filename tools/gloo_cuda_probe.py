#!/usr/bin/env python3
"""Which collectives gloo carries for two ranks that share one CUDA card.

NCCL takes one card a rank, so two ranks on one card join a gloo group,
which stages CUDA tensors through the host.  For each collective, as
c10d calls it, as a functional collective (``_c10d_functional``, which
DTensor calls) and as a point-to-point exchange, this starts two fresh
ranks on ``cuda:0`` (each case alone: a case that crashes a rank ends
only its own pair), runs it once on float32 ones at each size, and
prints one JSON line a case: each rank's exit code and whether the
result is the sum, gather or exchange it should be.  Last, the card's
name and power limit and the torch and CUDA versions.

    python3 tools/gloo_cuda_probe.py [--sizes 8,1000000]

It runs no code of the port, so that it shows gloo as it is (the port
stages what this finds broken: ``repro_torch.launch.world``).  Exits
non-zero without a card.
"""
import argparse
import datetime
import faulthandler
import json
import os
import subprocess
import sys
import tempfile

CASES = ("c10d.all_reduce", "c10d.all_gather_into_tensor",
         "c10d.reduce_scatter_tensor", "c10d.all_to_all_single",
         "funcol.all_reduce", "funcol.all_gather_into_tensor",
         "funcol.reduce_scatter_tensor", "funcol.all_to_all_single",
         "batch_isend_irecv")


def run_case(rank, case, n, path, results):
    """One rank of ``case`` on ``n`` float32 ones times (rank + 1)."""
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(path, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    group = dist.group.WORLD.group_name
    f = torch.ops._c10d_functional
    x = torch.ones(n, device=dev) * (rank + 1)
    if case == "c10d.all_reduce":
        dist.all_reduce(x)
        got, want = x, torch.full_like(x, 3.0)
    elif case == "c10d.all_gather_into_tensor":
        got = torch.empty(2 * n, device=dev)
        dist.all_gather_into_tensor(got, x)
        want = torch.cat([torch.ones(n), 2 * torch.ones(n)]).to(dev)
    elif case == "c10d.reduce_scatter_tensor":
        got = torch.empty(n // 2, device=dev)
        dist.reduce_scatter_tensor(got, x)
        want = torch.full_like(got, 3.0)
    elif case == "c10d.all_to_all_single":
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x)
        want = torch.cat([torch.ones(n // 2),
                          2 * torch.ones(n - n // 2)]).to(dev)
    elif case == "funcol.all_reduce":
        got = f.wait_tensor(f.all_reduce(x, "sum", group))
        want = torch.full_like(x, 3.0)
    elif case == "funcol.all_gather_into_tensor":
        got = f.wait_tensor(f.all_gather_into_tensor(x, 2, group))
        want = torch.cat([torch.ones(n), 2 * torch.ones(n)]).to(dev)
    elif case == "funcol.reduce_scatter_tensor":
        got = f.wait_tensor(f.reduce_scatter_tensor(x, "sum", 2, group))
        want = torch.full((n // 2,), 3.0, device=dev)
    elif case == "funcol.all_to_all_single":
        got = f.wait_tensor(f.all_to_all_single(
            x, [n // 2, n - n // 2], [n // 2, n - n // 2], group))
        want = torch.cat([torch.ones(n // 2),
                          2 * torch.ones(n - n // 2)]).to(dev)
    else:
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, got, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        want = torch.full_like(x, 2.0 - rank)
    torch.cuda.synchronize()
    results.put((rank, bool(torch.equal(got, want))))
    dist.destroy_process_group()


def main() -> None:
    import torch
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="8,1000000")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_probe: no CUDA device is available")
    ctx = mp.get_context("spawn")
    for case in CASES:
        for n in (int(s) for s in args.sizes.split(",")):
            results = ctx.Queue()
            with tempfile.TemporaryDirectory() as d:
                procs = [ctx.Process(target=run_case, args=(
                    r, case, n, os.path.join(d, "store"), results))
                    for r in range(2)]
                for p in procs:
                    p.start()
                for p in procs:
                    p.join(120)
                    if p.is_alive():
                        p.kill()
                        p.join()
            right = {}
            while not results.empty():
                rank, ok = results.get()
                right[rank] = ok
            print(json.dumps({"case": case, "n": n,
                              "exit_codes": [p.exitcode for p in procs],
                              "right": [right.get(r) for r in range(2)]}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)


if __name__ == "__main__":
    main()
