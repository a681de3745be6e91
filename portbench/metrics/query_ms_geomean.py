"""Geometric mean of the latency of every query completed in the window, all
kinds together (TPC-H's power-test form), in ms."""

import math


def read(run):
    lat = [q.latency_s for q in run.completed()]
    if not lat:
        return None
    return math.exp(sum(math.log(s * 1e3) for s in lat) / len(lat))
