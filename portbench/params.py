"""Query parameters drawn from a seed, by the rules a workload file states.

A rule is one of
  {"int": [lo, hi]}          a whole number uniform in [lo, hi];
  {"choice": [v, ...]}       one of the values, uniformly;
  {"sample": [[v, ...], k]}  k distinct values, in the order drawn.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def draw(rules: Dict[str, dict], rng: np.random.Generator) -> Dict[str, object]:
    out = {}
    for name, rule in rules.items():
        (how, arg), = rule.items()
        if how == "int":
            out[name] = int(rng.integers(arg[0], arg[1] + 1))
        elif how == "choice":
            out[name] = arg[int(rng.integers(len(arg)))]
        elif how == "sample":
            values, k = arg
            out[name] = [values[i] for i in rng.permutation(len(values))[:k]]
        else:
            raise ValueError(f"unknown parameter rule {how!r} for {name!r}")
    return out


def key(params: Dict[str, object]) -> str:
    """A parameter set as a string, equal for equal sets."""
    return repr(sorted((k, tuple(v) if isinstance(v, list) else v) for k, v in params.items()))
