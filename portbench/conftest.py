"""pytest settings of the benchmark's tests (``python -m pytest portbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; each such test decides inside itself and skips without one",
    )
