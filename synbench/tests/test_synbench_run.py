"""The command's contract around a run: no card, no result; the benchmark
alone, without the program, does not run; the result line's keys."""
import json
import os
import shutil
import subprocess
import sys
import tempfile

from synbench.core import spec

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
