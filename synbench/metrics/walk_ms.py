"""walk_ms: host milliseconds a request spends in ``Emulator.emulate``'s
walks over its profile: grouping the samples (span ``emulate.collapse``),
totalling them (``emulate.totals``) and folding the consumed amounts over
the rows (``replay.fold``), from the program's own spans.  One reader for
every emulate cell (``walk_ms.prompts``, ``walk_ms.decode``)."""
from synbench.core.program import ms_per_root, recorded


def read(run):
    return ms_per_root(recorded(run), ("emulate.collapse", "emulate.totals",
                                       "replay.fold"), "emulate")
