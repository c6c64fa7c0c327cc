"""One reader a per-layer metric, found by the metric's name: ``read(run)``
returns the metric's number, or None where the run holds nothing to read
it from (the harness then leaves the metric out of the line)."""
