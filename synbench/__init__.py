"""synbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 synbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/<config>.json`` with the plain reference that file names in
``reference/``, its traffic mix in ``traffic/<mix>.json`` with the runner
that file names in ``runners/``, and each per-layer metric's reader in
``metrics/<metric>.py``.

``core/`` and ``reference/`` are the yardstick: the datasheet peaks, the
roofline arithmetic, the seeded traffic generator, the trace reduction
and the plain references that decide ``correct``.  They import nothing
of the program; only ``runners/`` calls into ``repro_torch``.
"""
