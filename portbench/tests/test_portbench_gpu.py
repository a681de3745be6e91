"""On the card: a short traced run of a cell is correct and reads its
per-layer metrics, and the control is refused at SF 1.  Each test decides
inside itself whether there is a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.control import control_readings


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")


@pytest.mark.gpu
def test_a_traced_run_on_the_card():
    need_card()
    done = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"), "--workload",
         "sf1-q1-q6", "--seed", "4242", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT,
    )
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 < metrics["k2_roofline_share"] <= 100
    assert 0 < metrics["device_idle_share"] < 100
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]


@pytest.mark.gpu
def test_the_control_is_refused_on_the_card():
    need_card()
    readings = control_readings(harness.Cell("sf1-q3-q12"), 4243, 100, "cuda")
    assert any(c["value"] > c["limit"] for c in readings["checks"].values()), readings
