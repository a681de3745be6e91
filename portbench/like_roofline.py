"""The bytes a launch of the dictionary LIKE kernel (K4, ``csrc/dict_like.cu``)
must move over the benchmark's comment dictionary.

The program keeps a dictionary's bytes and offsets resident in the card's
memory and K4 writes its results there, so a launch's floor is these bytes
at the published HBM rate (``roofline.PEAK_BYTES_PER_S``).  Imports nothing
of the program.
"""


def dict_like_bytes(values) -> int:
    """Bytes one launch over the dictionary ``values`` (code order, the empty
    string first) must move: every entry's UTF-8 bytes and its int32 offset
    read once (one more offset than entries), one result byte an entry
    written once."""
    n = len(values)
    return sum(len(v.encode("utf-8")) for v in values) + 4 * (n + 1) + n
