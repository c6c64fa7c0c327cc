"""The per-layer metrics read from the program's own spans, counters and
segment row times (``synbench.core.program.recorded``): their arithmetic
on a hand-made record, what a traced rehearsal reads, the runners' facts
left as they were, and on a card the timed segment kernel's row stamps
against the trace."""
import os
import sys
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest

from synbench.core import harness, peaks, program, spec
from synbench.core.spans import Spans
from synbench.reference import emulation as emu_ref

ROOT = os.path.dirname(spec.HERE)
CELLS = ["qwen2-7b.emulate_prompts", "mamba2-780m.emulate_decode",
         "qwen2-7b.serve_prefill", "mamba2-780m.serve_prefill_pool"]
#: the metrics this file's readers give, by cell: (span metrics, row
#: metrics, which read the timed kernel's stamps on a card only)
NEW = {"qwen2-7b.emulate_prompts": (
           ["walk_ms.prompts", "schedule_ms.prompts", "launch_ms.prompts"],
           ["burn_rows_roofline.prompts"]),
       "mamba2-780m.emulate_decode": (
           ["walk_ms.decode", "schedule_ms.decode", "launch_ms.decode"],
           ["ring_rows_roofline.decode"]),
       "qwen2-7b.serve_prefill": (["pad_share", "prefill_enqueue_ms"], []),
       "mamba2-780m.serve_prefill_pool": (
           ["pad_share.ssd", "prefill_enqueue_ms.ssd"], [])}


def _span(name, id_, parent, request, start, end, counts=None):
    return {"name": name, "id": id_, "parent": parent, "request": request,
            "start_ns": start, "end_ns": end, "attrs": {},
            "counts": counts or {}}


#: the benchmark's ``window`` span of a hand-made run
WINDOW = (5, 2 ** 62)


def _view(record, monkeypatch, window=True):
    """A run whose program's recorder holds ``record`` over the
    benchmark's ``window`` span (``record`` None: no recorder loaded, as
    in a program that records no spans)."""
    if record is None:
        monkeypatch.delitem(sys.modules, program.RECORDER, raising=False)
    else:
        def window_of(t0, t1):
            assert (t0, t1) == WINDOW
            return record
        monkeypatch.setitem(sys.modules, program.RECORDER,
                            NS(window=window_of))
    spans = Spans()
    spans.done.append(("request", 6, 7))
    if window:
        spans.done.append(("window",) + WINDOW)
    return NS(facts={"requests": 2}, timeline=None, spans=spans,
              window_s=1.0)


def _read(name, record, monkeypatch):
    return spec.load_reader(name).read(_view(record, monkeypatch))


def test_span_readers_hand_worked(monkeypatch):
    ms = 10 ** 6
    spans = [
        # request 1: collapse 2 ms, compile 1 ms, totals 3 ms, launch
        # 0.5 ms, fold 1 ms
        _span("emulate", 1, None, 1, 0, 20 * ms),
        _span("emulate.collapse", 2, 1, 1, 0, 2 * ms),
        _span("schedule.compile", 3, 1, 1, 2 * ms, 3 * ms),
        _span("emulate.totals", 4, 1, 1, 3 * ms, 6 * ms),
        _span("replay", 5, 1, 1, 6 * ms, 20 * ms),
        _span("segment.launch", 6, 5, 1, 6 * ms, 6 * ms + ms // 2),
        _span("replay.fold", 7, 5, 1, 19 * ms, 20 * ms),
        # request 8: collapse 4 ms, compile 3 ms, launch 1.5 ms
        _span("emulate", 8, None, 8, 30 * ms, 40 * ms),
        _span("emulate.collapse", 9, 8, 8, 30 * ms, 34 * ms),
        _span("schedule.compile", 10, 8, 8, 34 * ms, 37 * ms),
        _span("segment.launch", 11, 8, 8, 37 * ms, 38 * ms + ms // 2),
        # a span of no emulate root in the window is not read
        _span("emulate.collapse", 12, 99, 99, 41 * ms, 50 * ms),
    ]
    p = {"spans": spans, "counters": {}, "rows": []}
    assert _read("walk_ms.decode", p, monkeypatch) == pytest.approx((6 + 4) / 2)
    assert _read("walk_ms.prompts", p, monkeypatch) == pytest.approx(5.0)
    assert _read("schedule_ms.decode", p, monkeypatch) == pytest.approx((1 + 3) / 2)
    assert _read("launch_ms.prompts", p, monkeypatch) == pytest.approx((0.5 + 1.5) / 2)
    waves = {"spans": [
        _span("serve.wave", 1, None, 1, 0, 400 * ms),
        _span("serve.prefill", 2, 1, 1, 10 * ms, 18 * ms),
        _span("serve.wave", 3, None, 3, 400 * ms, 800 * ms),
        _span("serve.prefill", 4, 3, 3, 410 * ms, 422 * ms)],
        "counters": {"serve.prompt_tokens": 6000, "serve.positions": 9600},
        "rows": []}
    assert _read("prefill_enqueue_ms", waves, monkeypatch) == pytest.approx(10.0)
    assert _read("pad_share", waves, monkeypatch) == pytest.approx(37.5)


def test_row_readers_hand_worked(monkeypatch):
    # one row of 67e9 operations (1 ms at the fp32 peak) and 3.35e6 bytes
    # taking 2 ms, one of 6.7e9 bytes (2 ms at HBM's rate) and 6.7e6
    # operations taking 2.5 ms, one of each taking 1 ms (ring: 1 ms at
    # HBM, burn 0.5 ms)
    p = {"spans": [], "counters": {}, "rows": [
        {"t_ns": 0, "span": 1, "request": 1,
         "ns": [2_000_000, 2_500_000],
         "flops": [67e9, 6.7e6], "bytes": [3.35e6, 6.7e9]},
        {"t_ns": 1, "span": 2, "request": 2, "ns": [1_000_000],
         "flops": [33.5e9], "bytes": [3.35e9]}]}
    assert peaks.FP32_FLOPS == 67e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    assert _read("burn_rows_roofline.prompts", p, monkeypatch) == pytest.approx(50.0)
    assert _read("ring_rows_roofline.decode", p, monkeypatch) == pytest.approx(
        100.0 * 3e-3 / 3.5e-3)


@pytest.mark.parametrize("name", sorted(
    {n for s, r in NEW.values() for n in s + r}))
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    """The parent's program loads no span recorder; a run without the
    benchmark's ``window`` span has no window; a window where nothing was
    recorded holds empty lists.  Each reader then returns None and raises
    nothing."""
    read = spec.load_reader(name).read
    assert read(_view(None, monkeypatch)) is None
    view = _view(None, monkeypatch)
    monkeypatch.setitem(sys.modules, program.RECORDER, NS())  # no window()
    assert read(view) is None
    empty = {"spans": [], "counters": {}, "rows": [], "dropped": {}}
    assert read(_view(empty, monkeypatch, window=False)) is None
    assert read(_view(empty, monkeypatch)) is None


def _rehearse(cell, trace, monkeypatch):
    """A whole rehearsal run; returns the harness's runner and the view
    its per-layer readers were given (None untraced)."""
    views, runners = [], []
    view_cls = harness.RunView

    class Kept(view_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            views.append(self)
    monkeypatch.setattr(harness, "RunView", Kept)
    c = spec.resolve(ROOT, cell, rehearse=True)
    runner_cls = c.runner().Runner

    class Seen(runner_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runners.append(self)
    monkeypatch.setattr(c.runner(), "Runner", Seen)
    rc = harness.main(["--workload", cell, "--seed", str(2 ** 32 + 21),
                       "--seconds", "0.3", "--trace", str(trace),
                       "--rehearse"], time.perf_counter(), ROOT)
    assert rc == harness.REHEARSAL_EXIT
    return runners[0], (views[0] if views else None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_rehearsal_reads_the_span_metrics(cell, monkeypatch):
    runner, view = _rehearse(cell, 1, monkeypatch)
    span_metrics, row_metrics = NEW[cell]
    c = spec.resolve(ROOT, cell, rehearse=True)
    assert {m["name"] for m in c.per_layer} >= set(span_metrics +
                                                    row_metrics)
    for name in span_metrics:
        v = spec.load_reader(name).read(view)
        assert v is not None and v > 0, name
    # no card: no timed kernel, no stamps
    for name in row_metrics:
        assert spec.load_reader(name).read(view) is None
    p = program.recorded(view)
    assert p["dropped"] == {"spans": 0, "rows": 0} and p["rows"] == []
    roots = [s for s in p["spans"] if s["parent"] is None]
    if "serve" in cell:
        assert len(roots) == len(runner.waves)
        # every wave pads its prompts to the longest: the counters are
        # the sums over the window's waves
        want_pos = sum(runner.B * max(r.prompt for r in w["meta"])
                       for w in runner.waves)
        want_tok = sum(r.prompt for w in runner.waves for r in w["meta"])
        assert p["counters"] == {"serve.positions": want_pos,
                                 "serve.prompt_tokens": want_tok}
    else:
        assert len(roots) == sum(1 for c_ in runner.calls if c_["window"])
        assert {s["name"] for s in roots} == {"emulate"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_runners_other_facts_are_as_they_were(cell, monkeypatch):
    """The facts hold the keys they held before the program recorded
    spans, and what the accepted readers read, worked out again here."""
    runner, _ = _rehearse(cell, 0, monkeypatch)
    f = runner.facts()
    if "serve" in cell:
        assert sorted(f) == ["flash_bound_s", "flash_launches",
                             "flash_symbol", "requests", "useful_flops"]
        assert f["flash_symbol"] == "fa_sm90"
        assert f["requests"] == runner.attempted
        sizes = runner.cell.sizes
        assert f["useful_flops"] == sum(
            runner.ref.request_flops(sizes, r.prompt)
            for w in runner.waves for r in w["meta"])
        # one flash launch a layer where the model has attention (sum()
        # adds floats with compensation: the runner adds them in turn)
        L = runner.ref.dims(sizes)["L"] if "qwen2" in cell else 0
        assert f["flash_bound_s"] == pytest.approx(sum(
            L * max(f_ / peaks.BF16_FLOPS, b / peaks.HBM_BYTES_PER_S)
            for f_, b in (runner.ref.flash_launch(
                sizes, runner.B, max(r.prompt for r in w["meta"]))
                for w in runner.waves if L)), rel=1e-12, abs=0)
    else:
        assert sorted(f) == ["requests", "roofline_s", "segment_bound_s",
                             "segment_launches", "segment_symbol"]
        win = [c for c in runner.calls if c["window"]]
        assert f["requests"] == len(win)
        assert f["segment_symbol"] == "segment_kernel"
        assert f["segment_launches"] == 0       # the CPU launches none
        assert f["roofline_s"] == sum(emu_ref.roofline_s(
            runner.profiles[c["key"]].samples, peaks.FP32_FLOPS,
            peaks.HBM_BYTES_PER_S) for c in win)
        assert f["segment_bound_s"] == sum(emu_ref.rows_bound_s(
            emu_ref.runs(runner.profiles[c["key"]].samples),
            peaks.FP32_FLOPS, peaks.HBM_BYTES_PER_S) for c in win)
    # untraced: the program recorded nothing in the window
    from repro_torch.obs import spans as recorder
    w = recorder.window(runner.t0_ns, runner.t1_ns)
    assert w["spans"] == [] and w["rows"] == [] and w["counters"] == {}


@pytest.mark.card
def test_the_timed_kernel_stamps_every_row_the_trace_times(card):
    """Tile 256, 16 MiB ring slots, 96 rows mixing burns, passes and empty
    rows: a stamp at every row that ran and none elsewhere, and the rows'
    device time within 2% of the kernel's time in the profiler's
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.memory_atom.kernel import Ring
    from repro_torch.kernels.segment import kernel as sk

    rows = [[20, 0, 0], [0, 2, 0], [0, 0, 0], [5, 1, 0]] * 24
    table = np.asarray(rows + [[0, 0, 0]] * 32, np.int32)
    x = torch.eye(256, device=card) * 0.5
    ring = Ring(1 << 24, card)
    sk.run_segment(table, x, ring, timed=True)      # built and warm
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = sk.run_segment(table, x, ring, timed=True)
        torch.cuda.synchronize(card)
    run.settle()
    stamps = run.stamps.cpu().numpy()
    ran = table.any(axis=1)
    assert ((stamps[:len(table)] != 0) == ran).all()
    ends = stamps[:len(table)][ran]
    assert (np.diff(ends) > 0).all() and ends[0] > stamps[-1]
    rows_ns = int(ends[-1] - stamps[-1])
    from torch.autograd import DeviceType
    kern = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and "segment_kernel" in e.name()]
    assert len(kern) == 1
    assert abs(rows_ns - kern[0].duration_ns()) <= 0.02 * \
        kern[0].duration_ns()
