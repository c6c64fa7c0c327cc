"""prefill_enqueue_ms: host milliseconds a wave spends in the prefill
step's call, which enqueues the model's work on the card and returns
before it runs (the program's span ``serve.prefill``).  A reading near
the wave's time would mean the forward syncs with the card."""
from synbench.core.program import ms_per_root, recorded


def read(run):
    return ms_per_root(recorded(run), ("serve.prefill",), "serve.wave")
