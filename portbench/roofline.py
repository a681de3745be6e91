"""The chip's published peaks and the bytes a kernel launch must move.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 80 GB
of HBM3 at 3.35 TB/s.  A share of a roofline is stated against them, with the
card's power limit beside it.
"""

PEAK_BYTES_PER_S = 3.35e12


def grouped_piece_sums_bytes(rows: int, widths, n_specs: int, num_groups: int) -> int:
    """Bytes one launch of the grouped piece-sum kernel (K2) must move: each
    input byte once, at the width the kernel reads it (every operand column
    and the group ids, ``rows`` each), and each output byte once (an int64 a
    spec and group)."""
    return rows * sum(widths) + n_specs * num_groups * 8
