"""Q13 worked out from the generated customer and orders_text columns: the
comments that hold WORD1 and, after it, WORD2 found by its own byte matching
over the comment dictionary laid out as a padded matrix (one row an entry),
the other orders counted by customer (0 for a customer with none), and the
customers counted by that count, ordered by that number descending, then
the count descending."""

import torch

from ..columns.orders_text import o_comment
from . import unscaled, wide

BLOCK_ROWS = 1 << 21  # dictionary rows matched at a time


def comment_matrix(memo, device):
    """(the comment dictionary in code order as an [entries, width] uint8
    matrix padded with zeros, each entry's byte length), kept in ``memo``."""
    if "comment_matrix" not in memo:
        values = [""] + o_comment.categories()
        flat = "".join(values).encode("utf-8")
        lens = torch.tensor([len(v.encode("utf-8")) for v in values], dtype=torch.int64)
        starts = torch.cumsum(lens, 0) - lens
        data = torch.frombuffer(bytearray(flat), dtype=torch.uint8).to(device)
        lens, starts = lens.to(device), starts.to(device)
        width = int(lens.max())
        matrix = torch.zeros((len(values), width), dtype=torch.uint8, device=device)
        for j in range(width):
            inside = lens > j
            matrix[inside, j] = data[starts[inside] + j]
        memo["comment_matrix"] = (matrix, lens)
    return memo["comment_matrix"]


def _find(rows, lens, word: bytes, after):
    """Where the first ``word`` at or after byte ``after`` ends in each row,
    and whether there is one."""
    width, k = rows.shape[1], len(word)
    if k > width:
        none = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
        return none, after
    hit = rows[:, : width - k + 1] == word[0]
    for t in range(1, k):
        hit &= rows[:, t : width - k + 1 + t] == word[t]
    j = torch.arange(width - k + 1, device=rows.device)
    hit &= (j + k <= lens[:, None]) & (j >= after[:, None])
    first = torch.where(hit, j, width).min(1).values
    return hit.any(1), first + k


def matching(memo, device, word1: str, word2: str):
    """[entries] bool: the comment holds word1 and, after it, word2."""
    key = ("q13", word1, word2)
    if key not in memo:
        matrix, lens = comment_matrix(memo, device)
        parts = []
        for a in range(0, matrix.shape[0], BLOCK_ROWS):
            rows, n = matrix[a : a + BLOCK_ROWS], lens[a : a + BLOCK_ROWS]
            zero = torch.zeros(rows.shape[0], dtype=torch.int64, device=device)
            found1, end1 = _find(rows, n, word1.encode(), zero)
            found2, _ = _find(rows, n, word2.encode(), end1)
            parts.append(found1 & found2)
        memo[key] = torch.cat(parts)
    return memo[key]


def answer(data, p, precision="exact", memo=None):
    memo = {} if memo is None else memo
    cu, od = data["customer"], data["orders_text"]
    device = od["o_comment"].device
    keep = ~matching(memo, device, p["word1"], p["word2"])[od["o_comment"].long()]
    t = wide(precision)
    custkeys = cu["c_custkey"].long()
    size = int(max(custkeys.max(), od["o_custkey"].max())) + 1
    per_customer = torch.zeros(size, dtype=t, device=device).index_add_(
        0, od["o_custkey"].long()[keep], torch.ones(int(keep.sum()), dtype=t, device=device))
    c_count = per_customer[custkeys].round().long()
    custdist = torch.zeros(int(c_count.max()) + 1, dtype=t, device=device).index_add_(
        0, c_count, torch.ones(c_count.shape[0], dtype=t, device=device))
    present = torch.nonzero(custdist > 0).flatten().tolist()
    rows = sorted(((unscaled(custdist[v]), v) for v in present), key=lambda r: (-r[0], -r[1]))
    return [
        ("c_count", "int", 0, [v for _, v in rows]),
        ("custdist", "int", 0, [d for d, _ in rows]),
    ]
