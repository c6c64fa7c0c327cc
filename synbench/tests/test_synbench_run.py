"""The command's contract around a run: no card, no result; the benchmark
alone, without the program, does not run; the result line's keys; the
accepted cells' rehearsals as they printed before the serve runner's
repairs."""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

from synbench.core import harness, spec

ROOT = os.path.dirname(spec.HERE)


def _run_py(cwd, *args, env=None):
    return subprocess.run([sys.executable, "synbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run_py(ROOT, "--workload", "qwen2-7b.emulate_prompts", "--seed",
                "1", "--seconds", "1", "--trace", "0", env=env)
    assert r.returncode != 0
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


def test_the_benchmark_alone_does_not_run():
    """In a directory that holds only BENCHMARK.json and synbench/ the
    program is missing: the run fails and prints no result."""
    with tempfile.TemporaryDirectory() as d:
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), d)
        shutil.copytree(spec.HERE, os.path.join(d, "synbench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        r = _run_py(d, "--workload", "qwen2-7b.emulate_prompts", "--seed",
                    "1", "--seconds", "1", "--trace", "0", "--rehearse",
                    env={k: v for k, v in os.environ.items()
                         if k != "PYTHONPATH"})
        assert r.returncode != 0
        assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


def test_result_line_keys_and_order():
    from synbench.core.harness import Check, result_line
    line = result_line(True, 4, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                       {"platform": "gpu", "kind": "k", "count": 1,
                        "memory_peak_bytes": 1},
                       {"device_ops": [], "idle_gaps": []},
                       [Check("x", 0.0, 0.0)])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert json.loads(json.dumps(line)) == line
    assert line["checks"] == {"x": {"value": 0.0, "limit": 0.0}}


#: what one cycle's rehearsal (``--seconds 0``, seed 2**32 + 21) printed
#: before the serve runner took its flash launches from the reference and
#: its ``logit_err`` limit from the configuration: the counts and every
#: check with its limit.  ``logit_err``'s value (0.0415 then) is held to
#: its limit only: it follows the host's order of summation and the
#: program's rounding, which no runner repair touches
_EXACT = {"profile_bytes": [0.0, 0.0], "profile_dot_flops": [0.0, 0.0],
          "profile_samples": [0.0, 0.0], "table_rows": [0.0, 0.0],
          "consumed": [0.0, 0.0], "burn_err": [0.0, 0.0],
          "ring_err": [0.0, 0.0]}
BEFORE = {
    "qwen2-7b.emulate_prompts": (
        {"requests": 16, "distinct_profiles": 3, "rows": 36}, _EXACT),
    "mamba2-780m.emulate_decode": (
        {"requests": 16, "distinct_profiles": 15, "rows": 423}, _EXACT),
    "qwen2-7b.serve_prefill": (
        {"waves": 8, "requests": 32, "flash_launches": 0},
        {"tokens": [0.0, 0.0], "served_not_max": [0.0, 0.0],
         "logit_err": [None, 0.4]})}
#: the serve cell's facts from the same run, as the per-layer readers got
#: them
SERVE_FACTS = {"requests": 32, "useful_flops": 223506432.0,
               "flash_bound_s": 4.5483940298507456e-07,
               "flash_launches": 0, "flash_symbol": "fa_sm90"}


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_the_accepted_cells_rehearse_as_before(cell, monkeypatch, capsys):
    c = spec.resolve(ROOT, cell, rehearse=True)
    seen = []
    runner_cls = c.runner().Runner

    class Seen(runner_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)
    monkeypatch.setattr(c.runner(), "Runner", Seen)
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 32 + 21),
                       "--seconds", "0", "--trace", "0", "--rehearse"],
                      time.perf_counter(), ROOT)
    assert rc == harness.REHEARSAL_EXIT
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counts, checks = BEFORE[cell]
    assert line["counts"] == counts
    assert line["correct"] is True
    assert {k: [None if k == "logit_err" else v["value"], v["limit"]]
            for k, v in line["checks"].items()} == checks
    if "serve" in cell:
        assert seen[0].facts() == SERVE_FACTS


class _Only:
    """A reference module that holds only ``names``: any other attribute
    the runner reaches for raises."""

    def __init__(self, module, names):
        self._module, self._names = module, set(names)

    def __getattr__(self, name):
        if name not in self._names:
            raise AttributeError(f"the runner called {name!r}, which its "
                                 f"REFERENCE_NEEDS does not list")
        return getattr(self._module, name)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]])
def test_a_run_calls_on_the_reference_only_what_its_runner_lists(
        cell, trace, monkeypatch, capsys):
    """Each cell's rehearsal, traced (the facts the readers take) and not,
    with its reference cut down to its runner's ``REFERENCE_NEEDS`` (and
    ``flash_launch`` where ``flash_layers`` is above 0), runs to its end
    and is correct: the tuple names every call."""
    c = spec.resolve(ROOT, cell, rehearse=True)
    ref, needs = c.reference(), list(c.runner().REFERENCE_NEEDS)
    if "flash_layers" in needs and ref.flash_layers(c.sizes):
        needs.append("flash_launch")
    monkeypatch.setattr(spec.Cell, "reference",
                        lambda self: _Only(ref, needs))
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 32 + 23),
                       "--seconds", "0", "--trace", str(trace),
                       "--rehearse"], time.perf_counter(), ROOT)
    assert rc == harness.REHEARSAL_EXIT
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
