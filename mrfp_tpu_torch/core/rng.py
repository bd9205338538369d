"""RNG discipline of the port: one ``torch.Generator`` per step and role.

The reference draws host-side randomness mid-forward (three
``random.random()`` gates at deepv3.py:281-283, host-seeded torch RNG
re-drawing the OC weights at deepv3.py:290-306, ``torch.normal`` inside NP+
at deepv3.py:274-275). As in mrfp_tpu/core/rng.py, every draw of a step
comes from a stream that is a pure function of ``(seed, step, role)``, so a
run resumed from a checkpoint draws exactly what an unbroken run would.

The generators live on the CPU: gates are drawn there as Python bools (so a
plain ``if`` skips dead work without a device sync), and the NP+ draws and
the OC re-init are drawn there and copied to the device, so a CPU run and a
GPU run of the same step draw the same numbers. They are not JAX's numbers
(ROADMAP ground rules): the parity tests inject draws instead.

Under gradient accumulation each microbatch folds its index into the
``np_l0``, ``np_l1`` and ``dropout`` streams (``microbatch``), as
mrfp_tpu/train/step.py:114-128 does; the gates and ``oc_resample`` stay once
per optimizer step. Without accumulation no index is folded, so every
stream draws what it drew before accumulation existed.

The one stream drawn off the host is the DSN head's dropout mask: it has a
value per activation (9.4M at batch 8, 768x768), too many to draw on the
host each step, so its generator lives on the model's device
(``device_generator``), seeded from the same ``(seed, step, role)``. A
resumed run still draws what an unbroken one would; a CPU run and a GPU
run draw different masks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

ROLES = ("gates", "oc_resample", "np_l0", "np_l1", "dropout")


def role_seed(seed: int, step: int, role: str, microbatch: Optional[int] = None) -> int:
    """A 63-bit seed for ``(seed, step, role)``, mixed by numpy's
    SeedSequence; under accumulation the microbatch is its spawn key (a
    child stream: appending it to the entropy would not do, as a trailing
    0 leaves the mix unchanged)."""
    ss = np.random.SeedSequence([int(seed), int(step), ROLES.index(role)],
                                spawn_key=() if microbatch is None else (int(microbatch),))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def step_generators(seed: int, step: int) -> Dict[str, torch.Generator]:
    """One freshly seeded CPU generator per role for step ``step``."""
    return {role: torch.Generator().manual_seed(role_seed(seed, step, role))
            for role in ROLES}


def device_generator(seed: int, step: int, role: str, device,
                     microbatch: Optional[int] = None) -> torch.Generator:
    """A generator on ``device`` for ``role``'s stream at ``step`` (and
    ``microbatch``)."""
    return torch.Generator(device=device).manual_seed(
        role_seed(seed, step, role, microbatch))

