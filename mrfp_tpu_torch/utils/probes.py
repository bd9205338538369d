"""Debug probes (mrfp_tpu/utils/probes.py): the feature-similarity
instrumentation the reference keeps as commented leftovers
(utils_main.py:137-160: cosine-similarity dumps between backbone / OC
features and constants).

``cosine_sim`` computes the mean over the batch of the cosine similarity
between per-sample flattened features, in fp32; ``FeatureProbe`` appends
each value to a text file, as the reference's dump-to-txt pattern does.
"""

from __future__ import annotations

import torch


def cosine_sim(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean cosine similarity between per-sample flattened features."""
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    num = (af * bf).sum(dim=-1)
    den = torch.linalg.vector_norm(af, dim=-1) * torch.linalg.vector_norm(bf, dim=-1)
    return (num / den.clamp_min(eps)).mean()


class FeatureProbe:
    def __init__(self, path: str):
        self.path = path

    def log(self, a, b) -> float:
        """Append ``cosine_sim(a, b)`` to the file (a sync when the features
        are on the card); returns it."""
        v = float(cosine_sim(torch.as_tensor(a), torch.as_tensor(b)))
        with open(self.path, "a") as f:
            f.write(f"{v}\n")
        return v
