"""pad_share: the share of the positions the window prefilled that were
padding: 1 - real prompt tokens over slots x padded length, summed over
the waves (the program's counters ``serve.prompt_tokens`` and
``serve.positions``)."""
from synbench.core.program import counter, recorded


def read(run):
    p = recorded(run)
    tokens, positions = counter(p, "serve.prompt_tokens"), \
        counter(p, "serve.positions")
    if not positions or tokens is None:
        return None
    return 100.0 * (1.0 - tokens / positions)
