#!/usr/bin/env python3
"""The controls: the plain reference put in the program's place, in the
nearest precision below the one the cell states, must come out as not
correct.  For each seed this sets a cell up, runs a short window, and
prints the numbers the cell compares for the program (sound readings)
and for the control:

  * emulate cells state float32 FMA work: the burn's carry worked out in
    TF32 and the ring streamed in bfloat16 take the place of the
    kernel's outputs;
  * serve cells state bfloat16: the reference with its products in
    float8 e4m3 (the configuration's reference's ``final_hidden`` and
    ``head`` at ``precision="fp8"``) gives the logits at the last
    position of each checked row, where the program's are kept, and they
    are read through the cell's own comparison with the float32
    reference (``logit_err``).

    python3 synbench/controls.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--size cell|rehearsal] [--device cuda|cpu] \\
        [--fault scan_forgets]

``--fault`` plants a fault in the program first (``FAULTS``), so that the
program's readings are the faulty program's: its reading at the cell's
size, beside the control's.

The benchmark's own runs never run this.  ``tests/test_synbench_controls
.py`` runs it at the rehearsal size on a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forgetful_scan(scan):
    """Mamba-2's SSD scan (``ssm.ssd_chunked``'s signature) run on each
    chunk from a zero state: the state is forgotten at every chunk's
    start."""
    import torch.nn.functional as F

    def forgetful(x, dt, A, Bm, Cm, *, chunk, initial_state=None,
                  return_state=False):
        B, L = x.shape[:2]
        pad = -L % chunk
        n = (L + pad) // chunk

        def chunks(t):
            t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            return t.reshape(B * n, chunk, *t.shape[2:])
        out = scan(chunks(x), chunks(dt), A, chunks(Bm), chunks(Cm),
                   chunk=chunk, return_state=return_state)
        y = (out[0] if return_state else out).reshape(
            B, n * chunk, *x.shape[2:])[:, :L]
        if return_state:
            return y, out[1].reshape(B, n, *out[1].shape[1:])[:, -1]
        return y
    return forgetful


def _plant_scan_forgets(setattr_):
    from repro_torch.models import ssm
    setattr_(ssm, "ssd_chunked", forgetful_scan(ssm.ssd_chunked))


#: faults ``--fault`` plants, each given ``setattr``
FAULTS = {"scan_forgets": _plant_scan_forgets}


def _runner(cell_name: str, seed: int, rehearse: bool, device):
    from synbench.core import spec
    cell = spec.resolve(ROOT, cell_name, rehearse=rehearse)
    return cell.runner().Runner(cell, cell.reference(), device, seed,
                                rehearse)


def emulate_readings(runner) -> dict:
    """The program's checks, then the same with the burn's carries worked
    out in TF32 and the ring streamed in bfloat16 in place of the
    kernel's."""
    import torch
    from synbench.reference import emulation as emu_ref
    sound = {c.name: c.value for c in runner.checks()}
    for call in runner.calls:
        for run in call["launched"]:
            if run.y is not None:
                ci = int(emu_ref.table(runner._runs(call["key"]), runner.tile,
                                       runner.block)[:, 0].sum())
                run.y = emu_ref.burn(runner.tile, ci, run.y.device, tf32=True)
    ring = runner.em.memory.ring()
    # a bfloat16 pass multiplies by 1.0000001 rounded to bfloat16, which is
    # 1: the slot stays at its first value, whatever the passes
    one = torch.ones((), dtype=torch.bfloat16, device=ring.data.device)
    scale = torch.tensor(float(emu_ref.STREAM_SCALE), dtype=torch.bfloat16,
                         device=ring.data.device)
    ring.data.fill_((one * scale).float().item())
    control = {c.name: c.value for c in runner.checks()}
    return {"program": sound, "control": control}


def serve_readings(runner) -> dict:
    """The cell's ``logit_err`` over the checked requests for the program,
    and for the control: the float8 reference's logits at the same rows'
    last positions, against the same float32 reference."""
    import torch
    picked = runner.sample()
    t = time.perf_counter()
    ref_logits = runner.reference_logits(picked)
    program = runner.program_errs(picked, ref_logits)
    t_ref = time.perf_counter() - t
    rows = [torch.from_numpy(r) for r, _ in picked]
    sizes, w, ref = runner.cell.sizes, runner.weights, runner.ref
    with torch.no_grad():
        low = ref.final_hidden(w, rows, sizes, precision="fp8")
        low = ref.head(w, torch.stack([h[-1] for h in low]), sizes,
                       precision="fp8")
    control = ref.logit_err(low, ref_logits)
    return {"program": {"logit_err": max(program), "errs": program},
            "control": {"logit_err": max(control), "errs": control},
            "reference_s": t_ref, "checked": len(picked)}


def readings(cell_name: str, seed: int, seconds: float, rehearse: bool,
             device, fault: str = "") -> dict:
    """One seed's readings; ``fault`` names the fault already planted."""
    from synbench.core.spans import Spans
    runner = _runner(cell_name, seed, rehearse, device)
    runner.setup()
    runner.window(seconds, Spans())
    runner.release()
    if runner.cell.mix["runner"] == "emulate":
        out = emulate_readings(runner)
    else:
        out = serve_readings(runner)
    out.update(seed=seed, requests=runner.attempted, fault=fault or None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="synbench/controls.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--size", choices=("cell", "rehearsal"), default="cell")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=sorted(FAULTS), default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from synbench.core.harness import set_cache_dirs
    set_cache_dirs(ROOT)
    import torch
    device = torch.device(args.device)
    if args.fault:
        FAULTS[args.fault](setattr)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds,
                     args.size == "rehearsal", device, args.fault)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
