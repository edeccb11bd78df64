"""Each example of the port (temporalgps_torch/examples/) runs end to end at
the reference's small scale on the CPU (TGPS_SCALE=small, TGPS_DEVICE=cpu),
in a process of one thread, as tests/test_examples.py runs the
reference's."""

import os
import subprocess
import sys

import pytest

EXAMPLES = [
    "exact_time_inference",
    "exact_time_learning",
    "augmented_inference",
    "exact_space_time_inference",
    "exact_space_time_learning",
    "approx_space_time_inference",
    "approx_space_time_learning",
]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example(name):
    env = dict(os.environ, TGPS_SCALE="small", TGPS_DEVICE="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", f"temporalgps_torch.examples.{name}"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, f"{name} failed:\n{out.stdout}\n{out.stderr}"
    assert "ok" in out.stdout.splitlines()
