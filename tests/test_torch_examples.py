"""The port's examples run end to end on the CPU.

Each ``examples/torch_*.py`` runs with ``--device cpu`` in a subprocess
(its own timeout, one OpenMP thread for it and any worker process it
spawns, files it writes under the test's temporary directory), exits 0
and prints, last, the line its JAX package counterpart in ``examples/``
prints last.  On a card ``chip_smoke.py``'s ``examples`` phase runs them
on ``cuda``.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# example -> (extra arguments, the start of its last line, timeout in s)
EXAMPLES = {
    "quickstart": ([], "tpu v5e:  step=", 120),
    "portability_study": (
        [], "OK: dominant resource flips across machines (paper Fig. 3).",
        120),
    "scenario_fleet": ([], "store: scenario=", 180),
    "dag_demo": (["{tmp}/dag_trace.json"],
                 "open at https://ui.perfetto.dev (enable flow events)", 180),
    "trace_demo": (["{tmp}/fleet_trace.json"],
                   "re-ran the storm: event sequence identical "
                   "(deterministic)", 240),
    "service_demo": ([], "p999 spike in faulted windows: ", 240),
    "metrics_demo": ([], "OK", 240),
    "serve_batched": ([], "served 6 requests in ", 120),
}


def test_every_torch_example_is_listed():
    found = sorted(f[len("torch_"):-len(".py")]
                   for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.startswith("torch_") and f.endswith(".py"))
    assert found == sorted([*EXAMPLES, "train_with_synapse"])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    extra, last, timeout = EXAMPLES[name]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"torch_{name}.py"),
         *(a.format(tmp=tmp_path) for a in extra), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith(last), \
        out.stdout[-2000:]


def test_examples_default_to_the_card():
    """Without ``--device`` every example asks for CUDA, and where there is
    none it exits non-zero naming it."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", f"torch_{name}.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in [*EXAMPLES, "train_with_synapse"]}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode != 0, name
        assert "--device cuda" in err and "CUDA" in err, (name, err)
