"""95th percentile of the latency of every query completed in the window, in
ms (linear interpolation between the closest ranks)."""

import numpy as np


def read(run):
    lat = [q.latency_s * 1e3 for q in run.completed()]
    return float(np.percentile(lat, 95)) if lat else None
