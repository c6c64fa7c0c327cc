"""A run with the timed path broken underneath must come out as not
correct: each fault a cell can have, planted in the program, drives a
whole rehearsal run (the harness's look for a card skipped) and reads
``correct``.  One card only, so no cell has an exchange between chips to
leave out."""
import json
import os
import time

import pytest

from synbench.core import harness, spec

ROOT = os.path.dirname(spec.HERE)
EMULATE = ["qwen2-7b.emulate_prompts", "mamba2-780m.emulate_decode"]
SERVE = ["qwen2-7b.serve_prefill", "mamba2-780m.serve_prefill_pool"]


def _run(cell, capsys, seed=2 ** 32 + 9):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.3", "--trace", "0", "--rehearse"],
                      time.perf_counter(), ROOT)
    assert rc == harness.REHEARSAL_EXIT
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", EMULATE + SERVE)
def test_a_sound_run_is_correct(cell, capsys):
    assert _run(cell, capsys)["correct"] is True


# -- emulate cells -----------------------------------------------------------

@pytest.mark.parametrize("cell", EMULATE)
def test_a_segment_that_leaves_its_state_unchanged(cell, capsys,
                                                   monkeypatch):
    from repro_torch.kernels.segment import kernel
    monkeypatch.setattr(kernel, "run_segment",
                        lambda table, x, ring, w=None, kind="all-reduce":
                        kernel.SegmentRun(x.clone() if x is not None
                                          else None, None, w))
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["ring_err"]["value"] > 0


@pytest.mark.parametrize("cell", EMULATE)
def test_half_of_the_rows_left_out(cell, capsys, monkeypatch):
    from repro_torch.core.schedule import FusedSegment, SegmentRunner
    launch = SegmentRunner.launch

    def half(self, segment):
        keep = max(1, segment.n_rows // 2)
        return launch(self, FusedSegment(segment.table[:keep],
                                         segment.rows[:keep]))
    monkeypatch.setattr(SegmentRunner, "launch", half)
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["ring_err"]["value"] > 0


@pytest.mark.parametrize("cell", EMULATE)
def test_a_consumed_amount_altered(cell, capsys, monkeypatch):
    from repro_torch.core.emulator import Emulator
    replay = Emulator.replay

    def altered(self, *a, **k):
        rep = replay(self, *a, **k)
        rep.consumed.flops += 1.0
        return rep
    monkeypatch.setattr(Emulator, "replay", altered)
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["consumed"]["value"] > 0


@pytest.mark.parametrize("cell", EMULATE)
def test_a_profile_altered(cell, capsys, monkeypatch):
    from repro_torch.core import static_profiler
    import repro_torch.core as core
    profile_step = static_profiler.profile_step

    def altered(*a, **k):
        prof, cost = profile_step(*a, **k)
        prof.samples[1].resources.hbm_bytes *= 0.5    # a layer's bytes
        return prof, cost
    monkeypatch.setattr(core, "profile_step", altered)
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["profile_bytes"]["value"] > 0


# -- the serve cells ---------------------------------------------------------

@pytest.mark.parametrize("cell", SERVE)
def test_a_served_token_altered(cell, capsys, monkeypatch):
    from repro_torch.serve import step
    greedy = step.greedy_token

    def altered(model, params, hidden_last):
        return (greedy(model, params, hidden_last) + 1) % \
            model.cfg.vocab_size
    monkeypatch.setattr(step, "greedy_token", altered)
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["served_not_max"]["value"] > 0


def _skip_transformer_layers(monkeypatch):
    from repro_torch.models import transformer
    block = transformer.block_apply

    def skipped(pl, x, **kw):
        y, cache, aux = block(pl, x, **kw)
        return x, cache, aux                     # the layer's update lost
    monkeypatch.setattr(transformer, "block_apply", skipped)


def _skip_ssm_mixers(monkeypatch):
    from repro_torch.models import ssm
    mixer = ssm.mamba2_block

    def skipped(p, x, **kw):
        out, cache = mixer(p, x, **kw)
        return out.new_zeros(out.shape), cache   # the mixer's update lost
    monkeypatch.setattr(ssm, "mamba2_block", skipped)


#: where each serve cell's layers are patched: Qwen2-7B's transformer
#: block, Mamba-2's mixer (``hybrid.make_ssm_block`` adds its output to
#: the residual stream)
SKIP_LAYERS = {"qwen2-7b.serve_prefill": _skip_transformer_layers,
               "mamba2-780m.serve_prefill_pool": _skip_ssm_mixers}


@pytest.mark.parametrize("cell", SERVE)
def test_a_layer_that_leaves_its_state_unchanged(cell, capsys, monkeypatch):
    SKIP_LAYERS[cell](monkeypatch)
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert line["checks"]["logit_err"]["value"] > \
        line["checks"]["logit_err"]["limit"]


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_the_batch_left_out(cell, capsys, monkeypatch):
    from repro_torch.serve.engine import Engine
    init = Engine.__init__

    def halved(self, *a, **k):
        init(self, *a, **k)
        prefill = self.prefill

        def first_half(params, batch):
            toks = batch["tokens"].clone()
            h = toks.shape[0] // 2
            toks[h:] = toks[:h]                  # rows past half not run
            return prefill(params, {"tokens": toks})
        self.prefill = first_half
    monkeypatch.setattr(Engine, "__init__", halved)
    line = _run(cell, capsys)
    assert line["correct"] is False


def test_the_scan_forgets_its_state_between_chunks(capsys, monkeypatch):
    """Mamba-2's SSD scan run on each chunk from a zero state
    (``controls.py --fault scan_forgets``, which reads it at the cell's
    size): the rehearsal's prompts span 2-8 chunks of 8."""
    from synbench import controls
    controls.FAULTS["scan_forgets"](monkeypatch.setattr)
    line = _run("mamba2-780m.serve_prefill_pool", capsys)
    assert line["correct"] is False
    assert line["checks"]["logit_err"]["value"] > \
        line["checks"]["logit_err"]["limit"]
