"""The benchmark of the PyTorch and CUDA port (``velox_tpu_torch``): TPC-H
power streams over device-resident scans.  ``run.py`` is its command."""
