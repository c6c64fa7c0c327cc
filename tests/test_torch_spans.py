"""The port's own spans and counters (``repro_torch.obs.spans``) on the
CPU: when they record, their clock against the profiler's, how they link,
what the emulator, the segment runner and the serving engine record, and
the host's side of the segment kernel's row times."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.run import RunConfig
from repro_torch.core import (Emulator, HostCalibration, ResourceVector,
                              Sample, SynapseProfile)
from repro_torch.core import emulator as emu_mod
from repro_torch.core.schedule import FusedSegment, record_row_times
from repro_torch.models.model_zoo import build_model
from repro_torch.obs import clock, spans
from repro_torch.serve.engine import Engine, Request

EVERYTHING = (0, 2 ** 63 - 1)


@pytest.fixture(autouse=True)
def fresh():
    spans.RECORDER.clear()
    yield
    spans.RECORDER.clear()


def names():
    return [s["name"] for s in spans.window(*EVERYTHING)["spans"]]


def test_spans_record_only_under_the_profiler_or_recording():
    with spans.span("before") as sp:
        assert sp is None
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert spans.on()
        with spans.span("profiled") as sp:
            assert sp is not None
    finally:
        prof.stop()
    assert not spans.on()
    with spans.span("between"):
        pass
    with spans.recording():
        with spans.span("recorded"):
            pass
    with spans.span("after"):
        pass
    assert names() == ["profiled", "recorded"]


def test_an_off_span_reads_no_clock_and_allocates_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")
    monkeypatch.setattr(clock, "epoch_ns", no_clock)
    monkeypatch.setattr(spans, "epoch_ns", no_clock)
    assert spans.span("a") is spans.span("b") is spans.OFF
    with spans.span("a") as sp:
        assert sp is None


def test_a_span_encloses_the_profilers_own_event():
    """One clock: the profiler's ``aten::mm`` event lies inside the span
    around the ``torch.mm`` that made it."""
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mm") as sp:
            torch.mm(a, a)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert sp.start_ns <= start <= end <= sp.end_ns
    # and the clock is the epoch's
    assert abs(clock.epoch_ns() - time.time_ns()) < 10 ** 9


def test_parents_requests_counters_and_drops():
    rec = spans.SpanRecorder(capacity=3)
    with spans.recording():
        with rec.open("root") as root:
            with rec.open("child") as child:
                with rec.open("leaf") as leaf:
                    leaf.count("n", 2)
                child.count("n", 3)
        with rec.open("other") as other:
            pass
    assert (root.parent, root.request) == (None, root.id)
    assert (child.parent, child.request) == (root.id, root.id)
    assert (leaf.parent, leaf.request) == (child.id, root.id)
    assert (other.parent, other.request) == (None, other.id)
    assert leaf.start_ns >= child.start_ns >= root.start_ns
    assert leaf.end_ns <= child.end_ns <= root.end_ns
    assert rec.counters == {"n": 5}
    # four closed into three places: the oldest (leaf) dropped
    win = rec.window(*EVERYTHING)
    assert [s["name"] for s in win["spans"]] == ["child", "root", "other"]
    assert win["dropped"] == {"spans": 1, "rows": 0}
    assert win["counters"] == {"n": 3}
    # a window holds the spans inside it only
    win = rec.window(root.start_ns, root.end_ns)
    assert [s["name"] for s in win["spans"]] == ["child", "root"]


def _profile():
    samples = [Sample(index=i, resources=ResourceVector(
        flops=2 * 64 ** 3 * 3, hbm_bytes=2 * 4096 * 2)) for i in range(5)]
    samples.append(Sample(index=5, resources=ResourceVector(
        flops=2 * 64 ** 3, hbm_bytes=0.0)))
    return SynapseProfile(command="spans", samples=samples)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_emulate_records_its_span_tree(backend, monkeypatch):
    em = Emulator(calib=HostCalibration(1.0, 1.0, 1.0, 1.0),
                  backend=backend, compute_tile=64, mem_block=4096,
                  device="cpu")
    called = []
    orig = emu_mod.compile_schedule

    def compile_schedule(*a, **k):
        called.append(1)
        return orig(*a, **k)
    # the seam: looked up in the emulator's module at call time
    monkeypatch.setattr(emu_mod, "compile_schedule", compile_schedule)
    prof = _profile()
    em.emulate(prof)                      # off: records nothing
    assert names() == [] and len(called) == 1
    with spans.recording():
        rep = em.emulate(prof)
    assert len(called) == 2
    assert rep.consumed.flops == prof.totals.flops
    got = {s["name"]: s for s in spans.window(*EVERYTHING)["spans"]}
    assert sorted(got) == sorted([
        "emulate", "emulate.collapse", "schedule.compile", "emulate.totals",
        "replay", "segment.launch", "segment.wait", "replay.fold"])
    root = got["emulate"]
    assert root["parent"] is None and root["attrs"] == {"samples": 6,
                                                        "rows": 2}
    parent = {"emulate.collapse": "emulate", "schedule.compile": "emulate",
              "emulate.totals": "emulate", "replay": "emulate",
              "segment.launch": "replay", "segment.wait": "replay",
              "replay.fold": "replay"}
    for name, s in got.items():
        assert s["request"] == root["id"]
        assert s["start_ns"] <= s["end_ns"]
        if name in parent:
            p = got[parent[name]]
            assert s["parent"] == p["id"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    # in the order the emulator runs them
    order = ["emulate.collapse", "schedule.compile", "emulate.totals",
             "segment.launch", "segment.wait", "replay.fold"]
    starts = [got[n]["start_ns"] for n in order]
    assert starts == sorted(starts)
    # no card: no timed launch, no row times
    assert spans.window(*EVERYTHING)["rows"] == []


def test_a_wave_records_its_spans_and_counters():
    cfg = reduced_config(get_config("qwen2-7b"))
    model = build_model(cfg, RunConfig(attn_impl="full",
                                       param_dtype="float32",
                                       compute_dtype="float32",
                                       cache_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(model, params, batch_slots=4, max_len=24, device="cpu")
    lens = [5, 9, 12]
    reqs = [Request(prompt=list(range(1, n + 1)), max_new_tokens=2)
            for n in lens]
    with spans.recording():
        eng.serve(reqs)
    assert all(len(r.out_tokens) == 2 for r in reqs)
    win = spans.window(*EVERYTHING)
    got = {s["name"]: s for s in win["spans"]}
    assert sorted(got) == ["serve.first_token", "serve.pad", "serve.prefill",
                           "serve.wave"]
    wave = got["serve.wave"]
    assert wave["attrs"] == {"prompt_tokens": 26, "positions": 4 * 12}
    for name in ("serve.pad", "serve.prefill", "serve.first_token"):
        assert got[name]["parent"] == wave["id"]
        assert got[name]["request"] == wave["id"]
    assert win["counters"] == {"serve.prompt_tokens": 26,
                               "serve.positions": 48}
    assert spans.RECORDER.counters == win["counters"]


def test_row_times_from_the_kernels_stamps():
    """A timed launch's stamps: one a table row (0 where the kernel skipped
    it; the padding's rows too) and the first row's start last."""
    rows = [ResourceVector(flops=float(f), hbm_bytes=float(b))
            for f, b in ((10, 1), (0, 0), (30, 3), (40, 4))]
    seg = FusedSegment(table=np.asarray([[1, 1, 0], [0, 0, 0], [3, 3, 0],
                                         [4, 4, 0]], np.int32), rows=rows)
    # 4 rows padded to 8, then the start
    stamps = np.asarray([150, 0, 400, 1000, 0, 0, 0, 0, 100], np.int64)
    with spans.recording():
        record_row_times(stamps, seg)
    got = spans.window(*EVERYTHING)["rows"]
    assert len(got) == 1
    assert got[0]["ns"] == [50, 250, 600]
    assert got[0]["flops"] == [10.0, 30.0, 40.0]
    assert got[0]["bytes"] == [1.0, 3.0, 4.0]
    spans.RECORDER.clear()
    record_row_times(np.zeros(9, np.int64), seg)   # nothing ran
    # a warm-up's table plans no amounts: nothing to set its times against
    record_row_times(stamps, FusedSegment(table=seg.table, rows=[]))
    assert spans.window(*EVERYTHING)["rows"] == []
