"""compile_ms: host milliseconds a request spends in ``Emulator.emulate``
outside its segment's launch and sync: grouping the samples, compiling
the iteration table, totalling the profile and folding the consumed
amounts.  From the benchmark's spans around each request and each
segment run."""


def read(run):
    n = run.spans.count("request")
    if not n:
        return None
    host = run.spans.total_s("request") - run.spans.total_s("segment.run")
    return 1e3 * host / n
