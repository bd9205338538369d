"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and skip without
one; the card is looked for inside the ``cuda_device`` fixture, never while
a module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)


# small sizes at which a CPU holds a whole run (the harness's own tests)
SMALL = {
    "train": {"train.batch_size": 4, "train.crop_size": 64, "traffic.warmup_steps": 1,
              "traffic.profile_steps": 2, "model.covstat_batches": 2},
    "eval": {"traffic.height_width": [64, 128], "traffic.pool_images": 8,
             "traffic.sweep_images": 2, "traffic.sample_among": 2, "traffic.sampled_sweeps": 1,
             "traffic.profile_images": 2, "traffic.warmup_images": 2},
}
