"""The 90th percentile of the window's step times (CUDA events at the step
boundaries), linear between the two nearest ranks."""

import numpy as np


def read(m):
    if m.traffic["driver"] != "train" or not m.step_ms:
        return None
    return float(np.percentile(m.step_ms, 90))
