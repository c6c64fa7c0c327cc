"""BENCHMARK.json and the files each cell is found by."""
import json
import os
import re

import pytest

from synbench.core import spec

ROOT = os.path.dirname(spec.HERE)
BENCH = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "synbench/run.py"]
    assert BENCH["paths"] == ["synbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip()
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.resolve(ROOT, cell)
    assert c.reference().port_fields(c.sizes)
    assert hasattr(c.runner(), "Runner")
    conf = next(x for x in BENCH["configs"]
                if x["name"] == c.workload["config"])
    assert conf["file"] == f"synbench/configs/{conf['name']}.json"
    assert conf["source"] == c.config["source"]
    assert sorted(conf["reduced"]) == sorted(c.config.get("reduced", []))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.load_reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_holds_what_the_runner_calls(cell):
    """Each runner names what it calls on the configuration's reference
    module (``REFERENCE_NEEDS``); a cell whose reference lacks one would
    fail on the card only when the runner reached it."""
    c = spec.resolve(ROOT, cell)
    ref, runner = c.reference(), c.runner()
    missing = [n for n in runner.REFERENCE_NEEDS if not hasattr(ref, n)]
    assert not missing, f"reference/{c.config['reference']}.py lacks " \
        f"{missing}, which runners/{c.mix['runner']}.py calls"
    if "flash_layers" in runner.REFERENCE_NEEDS and \
            ref.flash_layers(c.sizes):
        assert callable(ref.flash_launch)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_tiny(cell):
    c = spec.resolve(ROOT, cell, rehearse=True)
    assert c.mix.get("tile", 64) <= 64 or c.mix["runner"] != "emulate"
    d = c.reference().dims(c.sizes)
    assert d["D"] <= 64 and d["L"] <= 2


def test_a_split_metric_is_read_by_its_base_file():
    assert spec.reader_path("emulate_mfu.decode") == os.path.join(
        spec.HERE, "metrics", "emulate_mfu.py")
    assert spec.reader_path("serve_mfu") == os.path.join(
        spec.HERE, "metrics", "serve_mfu.py")
    for m in BENCH["per_layer"]:
        assert os.path.exists(spec.reader_path(m["name"]))


def test_departures_are_laid_over_the_published_config():
    c = spec.resolve(ROOT, "mamba2-780m.emulate_decode")
    assert c.config["config"]["norm_epsilon"] == 1e-05
    assert c.sizes["norm_epsilon"] == c.config["departures"]["norm_epsilon"]
    assert c.reference().dims(c.sizes)["V"] == 50280
    assert not set(c.config["departures"]) - set(c.config["config"])
