"""Edge cases of the two grouped-sum kernels, as data.

Each case is a small dict: the shape, a seed from which ``piece_numpy`` /
``group_sum_numpy`` make its numpy inputs (only when asked, so listing the
cases costs nothing), the slice offset of every array (an offset of 1 makes
the tensor start at an odd element, so its pointer is not 16-byte aligned)
and, for some, the number of table copies R that the launch geometry must
choose for the case's table.  ``chip_smoke.py`` and
``tests/test_torch_gpu_kernels.py`` run every case through the kernel and its
plain version and demand equal bits; ``tests/test_torch_kernel_geometry.py``
checks the geometry each case gets and holds the port against the JAX package
on the same inputs.

Covered: lengths 1, 15, 17, 1000 and 2**20 + 7; slices at odd elements, with
a common aligned start and without one; all rows dead; one group; 64 groups x
16 specs; the largest table the 48 KB limit admits; int8 and int32 group ids;
an int64 column whose products wrap; tables of such sizes that every number
of copies from 1 to 32 is run.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from ..ops import group_piece
from ..ops.launch_geometry import MAX_TABLE_BYTES

LENGTHS = (1, 15, 17, 1000, (1 << 20) + 7)
_COLUMN_TYPES = (np.int32, np.int16, np.int8, np.int8)
_COLUMN_RANGES = ((90000, 10500000), (100, 5001), (0, 11), (0, 9))


def _sliced(array: np.ndarray, offset: int, device) -> torch.Tensor:
    """A device tensor of ``array`` that starts ``offset`` elements into its
    allocation."""
    padded = np.concatenate([np.zeros((offset,), dtype=array.dtype), array])
    return torch.from_numpy(padded).to(device)[offset:]


def _q1_like_specs() -> List[List[group_piece.Factor]]:
    F = group_piece.Factor
    price = F(0, 1, 0, 90000, 10500000)
    disc = F(2, -1, 100, 90, 100)
    tax = F(3, 1, 100, 100, 108)
    return [[], [F(1, 1, 0, 100, 5000)], [price], [price, disc], [price, disc, tax],
            [F(2, 1, 0, 0, 10)]]


def _many_specs(count: int) -> List[List[group_piece.Factor]]:
    base = _q1_like_specs()
    return [base[i % len(base)] for i in range(count)]


def _piece_case(name, n, groups, specs, gid_type=np.int8, dead=0.1, offsets=None,
                copies=None, wide_column=False) -> Dict:
    return dict(
        name=name, n=n, groups=groups, specs=specs, gid_type=gid_type, dead=dead,
        offsets=offsets or [0] * (len(_COLUMN_TYPES) + 1), copies=copies,
        wide_column=wide_column,
    )


def piece_numpy(case: Dict):
    """(columns, group ids) of a case as numpy arrays."""
    rng = np.random.default_rng(case["seed"])
    n = case["n"]
    cols = [
        rng.integers(lo, hi, n).astype(t) for t, (lo, hi) in zip(_COLUMN_TYPES, _COLUMN_RANGES)
    ]
    if case["wide_column"]:  # products of these wrap mod 2**64
        cols[0] = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    gid = rng.integers(0, case["groups"], n)
    gid[rng.random(n) < case["dead"]] = -1
    return cols, gid.astype(case["gid_type"])


def piece_cases() -> Iterator[Dict]:
    """The cases of ``grouped_piece_sums``."""
    for position, case in enumerate(_piece_cases()):
        case["seed"] = 20240607 + position
        yield case


def _piece_cases() -> Iterator[Dict]:
    q1 = _q1_like_specs()
    for n in LENGTHS:
        yield _piece_case(f"n={n}", n, 6, q1)
    for n in (1000, (1 << 20) + 7):
        yield _piece_case(f"odd slices n={n}", n, 6, q1, offsets=[1] * 5)
    yield _piece_case("slices with no common aligned start", 5000, 6, q1,
                      offsets=[1, 2, 3, 5, 7])
    yield _piece_case("all rows dead", 4096 + 5, 6, q1, dead=1.1)
    yield _piece_case("one group", 1 << 16, 1, q1)
    yield _piece_case("64 groups x 16 specs", (1 << 18) + 3, 64, _many_specs(16),
                      gid_type=np.int32, copies=4)
    limit_groups = MAX_TABLE_BYTES // (8 * 3)
    yield _piece_case("table limit", 1 << 16, limit_groups, q1[:3], gid_type=np.int32, copies=1)
    yield _piece_case("int32 group ids", 70000, 12, q1, gid_type=np.int32, copies=32)
    yield _piece_case("int64 column, wrapping products", 70000, 12, q1, wide_column=True)
    # tables between Q1's (32 copies) and the limit (1 copy)
    yield _piece_case("128 groups x 16 specs", (1 << 17) + 21, 128, _many_specs(16),
                      gid_type=np.int32, copies=2)
    yield _piece_case("64 groups x 8 specs", (1 << 17) + 21, 64, _many_specs(8), copies=8)
    yield _piece_case("32 groups x 8 specs", (1 << 17) + 21, 32, _many_specs(8), copies=16)
    yield _piece_case("n=16", 16, 6, q1)


def piece_inputs(case: Dict, device):
    """(cols, gid_live, plans, num_groups) of a case on ``device``."""
    cols, gid = piece_numpy(case)
    arrays = [_sliced(a, o, device) for a, o in zip((*cols, gid), case["offsets"])]
    plans = [group_piece.plan_spec(s) for s in case["specs"]]
    return arrays[:-1], arrays[-1], plans, case["groups"]


def _sum_case(name, n, groups, ncols, live=0.9, offsets=None, copies=None) -> Dict:
    return dict(
        name=name, n=n, groups=groups, ncols=ncols, live=live,
        offsets=offsets or [0] * (ncols + 2), copies=copies,
    )


def group_sum_numpy(case: Dict):
    """(columns, group ids, mask) of a case as numpy arrays."""
    rng = np.random.default_rng(case["seed"])
    n, groups = case["n"], case["groups"]
    gids = rng.integers(-1, groups + 1, n).astype(np.int32)  # both ends out of range
    cols = [rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64) for _ in range(case["ncols"])]
    return cols, gids, rng.random(n) < case["live"]


def group_sum_cases() -> Iterator[Dict]:
    """The cases of ``grouped_int64_sums``."""
    for position, case in enumerate(_sum_cases()):
        case["seed"] = 20250607 + position
        yield case


def _sum_cases() -> Iterator[Dict]:
    for n in LENGTHS:
        yield _sum_case(f"n={n}", n, 12, 4)
    for n in (1000, (1 << 20) + 7):
        yield _sum_case(f"odd slices n={n}", n, 12, 4, offsets=[1] * 6)
    yield _sum_case("slices with no common aligned start", 5000, 12, 2, offsets=[1, 0, 3, 2])
    yield _sum_case("all rows dead", 4096 + 5, 12, 4, live=-1.0)
    yield _sum_case("one group", 1 << 16, 1, 4)
    yield _sum_case("64 groups x 16 columns", (1 << 17) + 3, 64, 16, copies=4)
    yield _sum_case("table limit", 1 << 16, MAX_TABLE_BYTES // (8 * 3), 3, copies=1)
    # tables between the usual one (32 copies) and the limit (1 copy)
    yield _sum_case("128 groups x 16 columns", (1 << 16) + 21, 128, 16, copies=2)
    yield _sum_case("64 groups x 8 columns", (1 << 17) + 21, 64, 8, copies=8)
    yield _sum_case("32 groups x 8 columns", (1 << 17) + 21, 32, 8, copies=16)
    yield _sum_case("n=16", 16, 12, 4, copies=32)


def group_sum_inputs(case: Dict, device):
    """(cols, gids, mask, num_groups) of a case on ``device``."""
    cols, gids, mask = group_sum_numpy(case)
    arrays = [_sliced(a, o, device) for a, o in zip((*cols, gids, mask), case["offsets"])]
    return arrays[:-2], arrays[-2], arrays[-1], case["groups"]
