"""burn_rows_roofline: over the segment rows the timed kernel ran whose
larger leg is the burn (their planned operations at the float32 peak
against their bytes at HBM's rate), their bound over their device time as
the kernel stamped it, row by row: where inside the segment kernel the
burn's rows stand against ``segment_roofline``'s arithmetic."""
from synbench.core import peaks
from synbench.core.program import recorded, rows_roofline


def read(run):
    return rows_roofline(recorded(run), "burn", peaks.FP32_FLOPS,
                         peaks.HBM_BYTES_PER_S)
