"""The port's command lines against the JAX package's, in this process.

``python -m repro_torch.scenarios list`` prints what the JAX package's
prints; ``run`` and ``fleet`` (thread executor) with ``--device cpu``
report the reference's totals and predictions; both CLIs refuse the same
bad arguments; and without ``--device cpu`` on a host without a card the
scenarios CLI and ``python -m repro_torch.service`` exit non-zero naming
the missing device, where the JAX package would have run on its default
platform.
"""
import json

import pytest
import torch

from repro.scenarios.__main__ import main as r_main
from repro_torch.scenarios.__main__ import main as t_main
from repro_torch.service.__main__ import main as service_main

MAINS = {"torch": t_main, "jax": r_main}
DEVICE = {"torch": ["--device", "cpu"], "jax": []}

SERVING = ["-p", "n_requests=1", "-p", "n_params=1e6",
           "-p", "prefill_tokens=32", "-p", "decode_tokens=4"]


def _run(pkg, argv, capsys):
    assert MAINS[pkg](argv) == 0
    return capsys.readouterr().out


def test_list_equals_reference(capsys):
    t, r = _run("torch", ["list"], capsys), _run("jax", ["list"], capsys)
    assert t == r
    assert "serving_traffic" in t and "deep_chain" in t


def _deterministic(out):
    """A run's JSON without the wall-clock fields."""
    rep = dict(out["report"])
    rep.pop("ttc_s")
    return {k: v for k, v in out.items()
            if k not in ("report", "emulated_ttc_s")}, rep


@pytest.mark.parametrize("name,params", [
    ("serving_traffic", SERVING),
    ("fanout_straggler", ["-p", "n_workers=3", "-p", "work_flops=5e7",
                          "-p", "work_hbm=4e7", "-p", "seed=7"]),
])
def test_run_json_equals_reference(name, params, capsys):
    outs = {pkg: json.loads(_run(pkg, ["run", name, *params, "--json",
                                       *DEVICE[pkg]], capsys))
            for pkg in MAINS}
    assert _deterministic(outs["torch"]) == _deterministic(outs["jax"])
    assert outs["torch"]["report"]["mode"] == "fused"


def test_fleet_json_on_threads_equals_reference(capsys):
    argv = ["fleet", "fanout_straggler:n_workers=3,work_flops=5e7,"
            "work_hbm=4e7,seed=7", "retry_storm:n_tasks=3,seed=2",
            "--workers", "2", "--json"]
    outs = {pkg: json.loads(_run(pkg, argv + DEVICE[pkg], capsys))
            for pkg in MAINS}
    for pkg, out in outs.items():
        for rep in out["reports"]:
            rep.pop("ttc_s")
        for k in ("wall_s", "serial_s", "speedup"):
            out["fleet"].pop(k, None)
    assert outs["torch"]["reports"] == outs["jax"]["reports"]
    assert outs["torch"]["fleet"]["n_profiles"] == 2


# the reference's argument errors (tests/test_scenarios.py), and the
# trace subcommand's
BAD = [
    ["run", "fanout_straggler", "-p", "nonsense"],
    ["fleet", "fanout_straggler", "--mesh", "2"],
    ["fleet", "fanout_straggler", "--per-sample", "--executor", "process"],
    ["fleet", "fanout_straggler", "--host", "h:1"],
    ["fleet", "fanout_straggler", "--executor", "remote"],
    ["fleet", "--from-store", "scenario=x"],
    ["fleet"],
    ["fleet", "fanout_straggler", "--autoscale", "0", "--executor",
     "process"],
    ["trace", "fanout_straggler", "--repeat", "0"],
    ["bogus"],
]


@pytest.mark.parametrize("argv", BAD, ids=lambda a: " ".join(a))
def test_bad_arguments_exit_like_reference(argv, capsys):
    for pkg in MAINS:
        with pytest.raises(SystemExit) as e:
            MAINS[pkg](list(argv))
        assert e.value.code not in (0, None)
        # an argument error, not the device check that comes after it
        assert "--device" not in str(e.value.code) + \
            capsys.readouterr().err


def test_mesh_exits_naming_the_roadmap_item(capsys):
    with pytest.raises(SystemExit) as e:
        t_main(["fleet", "fanout_straggler", "--mesh", "2", "--executor",
                "process", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and "item 3" in err


@pytest.mark.parametrize("argv", [
    ["run", "serving_traffic", *SERVING],
    ["fleet", "fanout_straggler", "--workers", "1"],
    ["serve", "--port", "0"],
])
def test_scenarios_cli_needs_the_card_unless_told(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(SystemExit) as e:
        t_main(argv)
    assert e.value.code not in (0, None)
    assert "--device cuda" in str(e.value.code)
    assert "CUDA" in str(e.value.code)
    # without emulation no device is needed
    if argv[0] == "run":
        assert t_main(argv + ["--no-emulate"]) == 0


def test_service_main_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(SystemExit) as e:
        service_main(["--port", "0"])
    assert e.value.code not in (0, None)
    assert "--device cuda" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        service_main(["--port", "0", "--device", "tpu"])
    assert e.value.code not in (0, None)
