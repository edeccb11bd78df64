"""Scale and device of the examples.

They run at full scale on the CUDA card by default. TGPS_SCALE=small runs
them at the reference's test scale, and TGPS_DEVICE=cpu on the CPU; nothing
is detected:

    TGPS_SCALE=small TGPS_DEVICE=cpu python -m temporalgps_torch.examples.exact_time_inference
"""

import os

import torch

SMALL = os.environ.get("TGPS_SCALE", "full") == "small"
DEVICE = os.environ.get("TGPS_DEVICE", "cuda")


def scaled(full, small):
    return small if SMALL else full


def generator(seed):
    """A torch.Generator on the examples' device, seeded."""
    return torch.Generator(device=DEVICE).manual_seed(seed)
