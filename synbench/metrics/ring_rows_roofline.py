"""ring_rows_roofline: ``burn_rows_roofline``'s arithmetic over the rows
whose larger leg is their planned bytes at HBM's rate (the ring's
rows)."""
from synbench.core import peaks
from synbench.core.program import recorded, rows_roofline


def read(run):
    return rows_roofline(recorded(run), "ring", peaks.FP32_FLOPS,
                         peaks.HBM_BYTES_PER_S)
