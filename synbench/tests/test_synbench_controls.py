"""The controls, on a card at the rehearsal size: the reference put in the
program's place one precision down must fail the cell's checks, while the
program passes them."""
import os

import pytest

from synbench import controls
from synbench.core import spec

ROOT = os.path.dirname(spec.HERE)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["qwen2-7b.emulate_prompts",
                                  "mamba2-780m.emulate_decode"])
def test_emulate_control_fails(card, cell):
    r = controls.readings(cell, 2 ** 32 + 1, 0.5, True, card)
    assert all(v == 0 for v in r["program"].values())
    assert r["control"]["burn_err"] > 0 and r["control"]["ring_err"] > 0


def _serve_control_fails(device, seeds):
    cell = spec.resolve(ROOT, "qwen2-7b.serve_prefill", rehearse=True)
    limit = cell.mix["logit_err_limit"]
    for seed in seeds:
        r = controls.readings(cell.name, seed, 0.5, True, device)
        assert r["program"]["logit_err"] <= limit
        assert r["control"]["logit_err"] > limit


@pytest.mark.card
def test_serve_control_fails(card):
    _serve_control_fails(card, (1, 2, 3))


def test_serve_control_fails_on_the_cpu():
    import torch
    _serve_control_fails(torch.device("cpu"), (2 ** 32 + 3,))
