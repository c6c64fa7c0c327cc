"""``burn_wait_share.prompts``: the share of the segment kernel's burn
time its burning CTAs spent waiting for a row of y, read from the
program's counters ``segment.burn_wait_ns`` and ``segment.burn_ns``.  Its
arithmetic on a hand-made record, and None wherever the counters are
absent, as in a program whose timed kernel does not sum them."""
import sys
from types import SimpleNamespace as NS

import pytest

from synbench.core import program, spec
from synbench.tests.test_synbench_program import (ROOT, _read, _rehearse,
                                                  _view)

NAME = "burn_wait_share.prompts"
CELL = "qwen2-7b.emulate_prompts"


def test_burn_wait_share_reads_the_burn_counters(monkeypatch):
    """100 x ``segment.burn_wait_ns`` over ``segment.burn_ns`` over the
    window; a record without the counters, or with no burn time, reads
    None."""
    ms = 10 ** 6
    both = {"spans": [], "rows": [], "counters": {
        "segment.burn_wait_ns": 3 * ms, "segment.burn_ns": 40 * ms}}
    assert _read(NAME, both, monkeypatch) == pytest.approx(7.5)
    for counters in ({}, {"segment.burn_ns": 40 * ms},
                     {"segment.burn_wait_ns": 0, "segment.burn_ns": 0}):
        rec = {"spans": [], "rows": [], "counters": counters}
        assert _read(NAME, rec, monkeypatch) is None


def test_burn_wait_share_without_a_recorder_reads_nothing(monkeypatch):
    """No recorder loaded, a recorder with no window, no ``window`` span,
    an empty window: None each time, and nothing raised."""
    read = spec.load_reader(NAME).read
    assert read(_view(None, monkeypatch)) is None
    view = _view(None, monkeypatch)
    monkeypatch.setitem(sys.modules, program.RECORDER, NS())
    assert read(view) is None
    empty = {"spans": [], "counters": {}, "rows": [], "dropped": {}}
    assert read(_view(empty, monkeypatch, window=False)) is None
    assert read(_view(empty, monkeypatch)) is None


def test_burn_wait_share_is_the_prompts_cells_and_silent_on_the_cpu(
        monkeypatch):
    """The cell lists the metric; a traced rehearsal here launches no
    timed kernel, so the counters are absent and the reader gives None."""
    c = spec.resolve(ROOT, CELL, rehearse=True)
    assert NAME in {m["name"] for m in c.per_layer}
    _, view = _rehearse(CELL, 1, monkeypatch)
    assert spec.load_reader(NAME).read(view) is None
