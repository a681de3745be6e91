"""Share of the byte roofline that the grouped piece-sum kernel (K2,
``csrc/grouped_piece_sums.cu``) reaches over the profiled stretch: the bytes
its launches must move (``roofline.grouped_piece_sums_bytes``) at the
published 3.35 TB/s, over the device time of those launches, in %.

A stretch with K2 kernels whose launches ``harness.K2Recorder`` did not all
record cannot be read, and the run stops: the byte count would be wrong."""

from ..roofline import PEAK_BYTES_PER_S, grouped_piece_sums_bytes


def read(run):
    prof = run.profile
    if prof is None:
        return None
    kernels = prof.kernels("grouped_piece_sums")
    launches = prof.k2_launches
    if not kernels:
        return None
    if len(kernels) != len(launches):
        raise RuntimeError(f"k2_roofline_share: {len(kernels)} K2 kernels in the trace against "
                           f"{len(launches)} recorded launches")
    bound_s = sum(grouped_piece_sums_bytes(**k) for k in launches) / PEAK_BYTES_PER_S
    device_s = sum(b - a for a, b, _ in kernels) * 1e-6
    return 100.0 * bound_s / device_s
