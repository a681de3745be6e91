"""Share of its roofline that the dictionary LIKE kernel (K4,
``csrc/dict_like.cu``) reaches over the profiled stretch: the bytes each
launch must move over the comment dictionary (``like_roofline.dict_like_bytes``)
at the published 3.35 TB/s of HBM, where the dictionary is resident, over
the device time of those launches, in %.

Each profiled query makes exactly one launch, in its build side; a stretch
with another number of K4 kernels cannot be read, and the run stops.  A
program without K4 has none in its trace, and the metric is absent."""

from ..columns.orders_text import o_comment
from ..like_roofline import dict_like_bytes
from ..roofline import PEAK_BYTES_PER_S


def read(run):
    prof = run.profile
    if prof is None:
        return None
    kernels = prof.kernels("dict_like_kernel")
    if not kernels:
        return None
    queries = len(run.profiled())
    if len(kernels) != queries:
        raise RuntimeError(f"like_roofline_share: {len(kernels)} K4 kernels in the trace for "
                           f"{queries} profiled queries")
    bound_s = queries * dict_like_bytes([""] + o_comment.categories()) / PEAK_BYTES_PER_S
    device_s = sum(b - a for a, b, _ in kernels) * 1e-6
    return 100.0 * bound_s / device_s
