"""One module a metric, found by the metric's name in ``BENCHMARK.json``.

``read(run)`` takes the ``harness.Run`` of one run and returns the metric's
value, or None when the run holds nothing to read (the harness then leaves
the metric out of the result line).  End-to-end metrics read the window's
host clocks; per-layer metrics read the traced run's spans and profile.
"""
