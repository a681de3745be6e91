"""orders_text.o_comment: free text of 19 to 78 characters (TPC-H v3 §4.2.3),
a distinct comment for every order.

The dictionary (``CATEGORIES``) is the same for every seed: ``N_COMMENTS``
distinct comments, as many as the orders at SF 10, made on the CPU from a
fixed stream the first time something reads it, so that no other cell pays
for it.  As in dbgen, a text pool is generated from the grammar of TPC-H
§4.2.2.14 and each comment is a window into it, at a random offset, of a
length uniform in [19, 78]; repeated windows are dropped.  A seed only
chooses which order gets which comment (``make``: a permutation drawn from
the seed's ``orders/comment`` stream).  ``comment_pool(n, seed)`` makes a
pool of any size for tests.

Every draw reads the raw 64-bit words of numpy's PCG64, whose stream does
not change between numpy versions, so every machine gets the same list.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...datagen import stream

TYPE = "VARCHAR"
N_COMMENTS = 15_000_000  # orders at SF 10
POOL_SEED = 13
LENGTHS = (19, 78)
POOL_BYTES_PER_COMMENT = 8  # the text pool's size, with 1 MiB at least

# The word lists and weights of dbgen's dists.dss (TPC-H §4.2.2.14), written
# from memory: listed under ``assumed`` in configs/tpch-sf10-comments.json.
NOUNS = {
    "packages": 40, "requests": 40, "accounts": 40, "deposits": 40, "foxes": 20,
    "ideas": 20, "theodolites": 20, "pinto beans": 20, "instructions": 20,
    "dependencies": 10, "excuses": 10, "platelets": 10, "asymptotes": 10, "courts": 5,
    "dolphins": 5, "multipliers": 1, "sauternes": 1, "warthogs": 1, "frets": 1, "dinos": 1,
    "attainments": 1, "somas": 1, "Tiresias": 1, "patterns": 1, "forges": 1, "braids": 1,
    "frays": 1, "warhorses": 1, "dugouts": 1, "notornis": 1, "epitaphs": 1, "pearls": 1,
    "tithes": 1, "waters": 1, "orbits": 1, "gifts": 1, "sheaves": 1, "depths": 1,
    "sentiments": 1, "decoys": 1, "realms": 1, "pains": 1, "grouches": 1, "escapades": 1,
    "hockey players": 1,
}
VERBS = {
    "sleep": 20, "wake": 20, "are": 20, "cajole": 20, "haggle": 20, "nag": 10, "use": 10,
    "boost": 10, "affix": 5, "detect": 5, "integrate": 5, "maintain": 1, "nod": 1, "was": 1,
    "lose": 1, "sublate": 1, "solve": 1, "thrash": 1, "promise": 1, "engage": 1, "hinder": 1,
    "print": 1, "x-ray": 1, "breach": 1, "eat": 1, "grow": 1, "impress": 1, "mold": 1,
    "poach": 1, "serve": 1, "run": 1, "dazzle": 1, "snooze": 1, "doze": 1, "unwind": 1,
    "kindle": 1, "play": 1, "hang": 1, "believe": 1, "doubt": 1,
}
ADJECTIVES = {
    "special": 20, "pending": 20, "unusual": 20, "express": 20, "furious": 1, "sly": 1,
    "careful": 1, "blithe": 1, "quick": 1, "fluffy": 1, "slow": 1, "quiet": 1, "ruthless": 1,
    "thin": 1, "close": 1, "dogged": 1, "daring": 1, "brave": 1, "stealthy": 1,
    "permanent": 1, "enticing": 1, "idle": 1, "busy": 1, "regular": 50, "final": 40,
    "ironic": 40, "even": 30, "bold": 20, "silent": 10,
}
ADVERBS = {
    "sometimes": 1, "always": 1, "never": 1, "furiously": 50, "slyly": 50, "carefully": 50,
    "blithely": 40, "quickly": 30, "fluffily": 20, "slowly": 1, "quietly": 1,
    "ruthlessly": 1, "thinly": 1, "closely": 1, "doggedly": 1, "daringly": 1, "bravely": 1,
    "stealthily": 1, "permanently": 1, "enticingly": 1, "idly": 1, "busily": 1,
    "regularly": 1, "finally": 1, "ironically": 1, "evenly": 1, "boldly": 1, "silently": 1,
}
PREPOSITIONS = {
    "about": 50, "above": 50, "according to": 50, "across": 50, "after": 50, "against": 40,
    "along": 40, "alongside of": 30, "among": 30, "around": 20, "at": 10, "atop": 1,
    "before": 1, "behind": 1, "beneath": 1, "beside": 1, "besides": 1, "between": 1,
    "beyond": 1, "by": 1, "despite": 1, "during": 1, "except": 1, "for": 1, "from": 1,
    "in place of": 1, "inside": 1, "instead of": 1, "into": 1, "near": 1, "of": 1, "on": 1,
    "outside": 1, "over": 1, "past": 1, "since": 1, "through": 1, "throughout": 1, "to": 1,
    "toward": 1, "under": 1, "until": 1, "up": 1, "upon": 1, "without": 1, "with": 1,
    "within": 1,
}
AUXILIARIES = {
    "do": 1, "may": 1, "might": 1, "shall": 1, "will": 1, "would": 1, "can": 1, "could": 1,
    "should": 1, "ought to": 1, "must": 1, "will have to": 1, "shall have to": 1,
    "could have to": 1, "should have to": 1, "must have to": 1, "need to": 1, "try to": 1,
}
TERMINATORS = {".": 50, ";": 1, ":": 1, "?": 1, "!": 1, "--": 1}
# sentences of noun (N), verb (V) and prepositional (P) phrases and a terminator
SENTENCES = {"NVT": 3, "NVPT": 3, "NVNT": 3, "NPVNT": 1, "NPVPT": 1}
NOUN_PHRASES = {("n",): 10, ("j", "n"): 20, ("j", ",", "j", "n"): 10, ("d", "j", "n"): 50}
VERB_PHRASES = {("v",): 30, ("x", "v"): 1, ("v", "d"): 40, ("x", "v", "d"): 1}
WORDS = {"n": NOUNS, "v": VERBS, "j": ADJECTIVES, "d": ADVERBS, "p": PREPOSITIONS,
         "x": AUXILIARIES, "t": TERMINATORS}
CLASSES = "nvjdpxt"


def _templates() -> Tuple[List[Tuple[str, ...]], np.ndarray]:
    """Every sentence the grammar can make, as word classes (and the fixed
    tokens ``,`` and ``the``), with its weight."""
    phrases = {
        "N": list(NOUN_PHRASES.items()),
        "V": list(VERB_PHRASES.items()),
        "P": [(("p", "the") + np_, w) for np_, w in NOUN_PHRASES.items()],
        "T": [(("t",), 1)],
    }
    out, weights = [], []
    for form, w_form in SENTENCES.items():
        for parts in itertools.product(*(phrases[s] for s in form)):
            out.append(tuple(tok for toks, _ in parts for tok in toks))
            weights.append(w_form * int(np.prod([w for _, w in parts])))
    return out, np.asarray(weights, dtype=np.float64)


def _uniform(raw: np.ndarray) -> np.ndarray:
    """Floats in [0, 1) from raw 64-bit words: their top 53 bits."""
    return (raw >> np.uint64(11)).astype(np.float64) * 2.0**-53


def _choose(bitgen, weights: np.ndarray, n: int) -> np.ndarray:
    """n indices drawn with the given weights."""
    cum = np.cumsum(weights / weights.sum())
    return np.minimum(np.searchsorted(cum, _uniform(bitgen.random_raw(n)), side="right"),
                      len(weights) - 1)


def _ints(bitgen, lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """n whole numbers, each uniform in [lo, hi] (below 2**32)."""
    span = (np.asarray(hi, dtype=np.uint64) - np.asarray(lo, dtype=np.uint64) + np.uint64(1))
    top = bitgen.random_raw(n) >> np.uint64(32)
    return (np.asarray(lo, dtype=np.uint64) + ((top * span) >> np.uint64(32))).astype(np.int64)


def text_pool(n_bytes: int, bitgen) -> str:
    """At least ``n_bytes`` of text from the grammar, sentences one after
    another, words separated by one space."""
    templates, weights = _templates()
    width = max(len(t) for t in templates)
    code = {c: i for i, c in enumerate(CLASSES)}
    code.update({",": len(CLASSES), "the": len(CLASSES) + 1})
    table = np.full((len(templates), width), -1, dtype=np.int64)
    for i, t in enumerate(templates):
        table[i, : len(t)] = [code[tok] for tok in t]
    # one token list: every class's words, then "," and " the"
    tokens: List[str] = []
    first: Dict[str, int] = {}
    for c in CLASSES:
        first[c] = len(tokens)
        tokens += [w if c == "t" else " " + w for w in WORDS[c]]
    tokens += [",", " the"]
    sizes = np.fromiter(map(len, tokens), dtype=np.int64)
    pieces, have = [], 0
    while have < n_bytes:
        n_sent = max(1024, (n_bytes - have) // 40)
        rows = table[_choose(bitgen, weights, n_sent)]
        classes = rows[rows >= 0]
        ids = classes.copy()
        ids[classes == code[","]] = len(tokens) - 2
        ids[classes == code["the"]] = len(tokens) - 1
        for c in CLASSES:
            at = np.flatnonzero(classes == code[c])
            w = np.asarray(list(WORDS[c].values()), dtype=np.float64)
            ids[at] = first[c] + _choose(bitgen, w, at.shape[0])
        pieces.append("".join(map(tokens.__getitem__, ids.tolist())))
        have += int(sizes[ids].sum())
    return "".join(pieces)


def comment_pool(n: int, seed: int) -> List[str]:
    """``n`` distinct comments, windows of length uniform in ``LENGTHS`` into
    a text pool, both drawn from ``seed``; the same list for the same (n,
    seed) on every machine."""
    bitgen = np.random.PCG64(seed)
    pool = text_pool(max(POOL_BYTES_PER_COMMENT * n, 1 << 20), bitgen)
    lo, hi = LENGTHS
    seen: Dict[str, None] = {}
    while len(seen) < n:
        m = n - len(seen) + (n - len(seen)) // 4 + 64
        lengths = _ints(bitgen, lo, hi, m)
        starts = _ints(bitgen, 0, len(pool) - lengths, m)
        seen.update(dict.fromkeys(
            [pool[s:e] for s, e in zip(starts.tolist(), (starts + lengths).tolist())]))
    return list(itertools.islice(seen, n))


_MADE: Dict[Tuple[int, int], List[str]] = {}


def categories() -> List[str]:
    """The dictionary: ``comment_pool(N_COMMENTS, POOL_SEED)``, made once."""
    key = (N_COMMENTS, POOL_SEED)
    if key not in _MADE:
        _MADE.clear()
        _MADE[key] = comment_pool(*key)
    return _MADE[key]


def __getattr__(name: str):
    if name == "CATEGORIES":
        return categories()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make(g) -> torch.Tensor:
    if g.n_orders > N_COMMENTS:
        raise ValueError(f"{g.n_orders} orders, {N_COMMENTS} distinct comments")
    gen = stream(g.seed, "orders", "comment", g.device)
    codes = torch.randperm(N_COMMENTS, generator=gen, device=g.device)[: g.n_orders]
    return (codes + 1).to(torch.int32)

