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


SERVE = ["qwen2-7b.serve_prefill", "mamba2-780m.serve_prefill_pool"]


def _serve_control_fails(cell_name, device, seeds):
    from synbench.runners.serve import logit_err_limit
    limit = logit_err_limit(spec.resolve(ROOT, cell_name, rehearse=True),
                            True)
    for seed in seeds:
        r = controls.readings(cell_name, seed, 0.5, True, device)
        assert r["program"]["logit_err"] <= limit
        assert r["control"]["logit_err"] > limit


@pytest.mark.card
@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_fails(card, cell):
    _serve_control_fails(cell, card, (1, 2, 3))


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_fails_on_the_cpu(cell):
    import torch
    _serve_control_fails(cell, torch.device("cpu"), (2 ** 32 + 3,))
