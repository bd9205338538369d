"""Checks shared by the port's multi-process step tests
(tests/test_torch_dist.py, tests/test_torch_spatial.py): a JAX key whose
first step fires every gate, the JAX configs of the step variants, the
1e-7-input control, and the rules that hold a step of several ranks
against one process's and against JAX's."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from mrfp_tpu.core.config import mrfp_plus_config as jax_mrfp_plus_config
from mrfp_tpu.core.rng import step_keys


def all_gates_key():
    """A JAX base key whose step-0 gates all fire."""
    for k in range(200):
        key = jax.random.PRNGKey(k)
        u = np.asarray(jax.random.uniform(step_keys(key, 0)["gates"], (3,)))
        if (u < 0.5).all():
            return key
    raise AssertionError("no key found")




def jax_cfg(variant: str):
    c = jax_mrfp_plus_config()
    train, data = dict(lr=1.0), {}
    if variant == "fused":
        train["fuse_bn_stats"] = True
    elif variant == "accum2":
        train["accum_steps"] = 2
    elif variant == "batch_weighting":
        data["batch_weighting"] = True
    elif variant == "jointwtborder":
        data.update(jointwtborder=True, border_window=2)
    return c.replace(train=dataclasses.replace(c.train, **train),
                     data=dataclasses.replace(c.data, **data))


def perturbed(img: torch.Tensor) -> torch.Tensor:
    """``img`` x (1 + 1e-7 noise): the control of the fp32 comparisons."""
    noise = torch.randn(img.shape, generator=torch.Generator().manual_seed(1))
    return img * (1 + 1e-7 * noise)


def as_close_as_the_control(two: dict, one: dict, control: dict, what: str) -> None:
    """Every tensor of ``two`` (2 ranks) within 3x the distance of
    ``control`` (one process on the input x (1 + 1e-7 noise)) from ``one``
    (one process), plus 1e-4 of its norm. On this fixture fp32 flips a few
    ReLUs (ROADMAP C3), so a 1e-7 change of the input moves the deep
    gradients ~4e-3; the ranks' other summation orders move them as far
    and no further."""
    worst = 0.0
    for k, v in one.items():
        if not v.is_floating_point():
            assert torch.equal(two[k], v), (what, k)
            continue
        err = float((two[k] - v).norm())
        bound = 3 * float((control[k] - v).norm()) + 1e-4 * float(v.norm()) + 1e-9
        worst = max(worst, err / bound)
        assert err <= bound, (what, k, err, bound)
    print(f"{what}: worst error / bound {worst:.3f}")


def as_close_as_the_control_or_fp64(two: dict, one: dict, control: dict, ref64: dict,
                                    grads: dict, what: str) -> None:
    """``as_close_as_the_control``, where a tensor past that rule is held
    instead no further from the step in fp64 than 3x the one-process
    step's distance + 1e-4 of its norm: ``ref64`` the fp64 step's
    gradients; for a parameter after the step (``grads`` then the
    one-process step's gradients), ``one``'s value moved by the gradients'
    difference at lr 1. Where a BatchNorm over the batch's 1x1 maps (the
    ASPP image pool) amplifies the last bits of near-equal pooled means,
    a 1e-7 change of the input moves the step far less than the ranks'
    other summation orders do; fp64 tells rounding from error."""
    worst = 0.0
    for k, v in one.items():
        if not v.is_floating_point():
            assert torch.equal(two[k], v), (what, k)
            continue
        err = float((two[k] - v).norm())
        bound = 3 * float((control[k] - v).norm()) + 1e-4 * float(v.norm()) + 1e-9
        worst = max(worst, err / bound)
        if err <= bound:
            continue
        assert k in ref64, (what, k, err, bound)
        ref = ref64[k] if grads is None else v - (ref64[k] - grads[k])
        far, near = float((two[k] - ref).norm()), float((v - ref).norm())
        print(f"{what} {k}: {err / bound:.1f}x the control rule; from fp64 {far:.3e}, "
              f"one process {near:.3e}")
        assert far <= 3 * near + 1e-4 * float(ref.norm()), (what, k, far, near)
    print(f"{what}: worst error / control bound {worst:.3f}")


def against_jax(two: dict, one: dict, control: dict, start: dict, after: dict, lr: float,
                 wd: float, fused: bool) -> None:
    """The 2-rank step against JAX's: every gradient (read back from JAX's
    update as ``(p0 - p1) / lr - wd * p0``) and BN statistic within the
    bounds of ``torch_port_fixture.assert_step_matches`` (gradients 1e-2
    of the norm, norm scales 5e-2, statistics 2e-3; the fused step's
    statistics rtol 2e-2, atol 1e-3), or, for a tensor where the
    one-process step itself lies further from JAX, within that distance
    plus the control's allowance (``as_close_as_the_control``). On this
    batch, with every gate on at batch 4, the one-process step's layer3.4
    gradients lie up to 1.6x the 1e-2 bound from JAX's; a 1e-7 change of
    the input moves them 3.6e-3 (ROADMAP C1, C3)."""
    got, want, ctrl = two["state"], one["state"], control["state"]
    over = []
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):  # JAX keeps no count
            continue
        if "running" in k:
            dist = lambda a: (a - v).abs() - (1e-3 + 2e-2 * v.abs()) if fused \
                else (a - v).norm() - 2e-3 * v.norm()  # noqa: E731
            err, allow = float(dist(got[k]).max()), max(0.0, float(dist(want[k]).max()))
            slack = 3 * float((ctrl[k] - want[k]).norm())
        else:
            p0 = start[k].double()
            g_jax = (p0 - v.double()) / lr - wd * p0
            bound = (5e-2 if k.endswith("weight") and v.dim() == 1 else 1e-2) * \
                float(g_jax.norm()) + 1e-6
            err = float((two["grads"][k].double() - g_jax).norm()) - bound
            allow = max(0.0, float((one["grads"][k].double() - g_jax).norm()) - bound)
            slack = 3 * float((control["grads"][k] - one["grads"][k]).norm())
        if allow > 0:
            over.append(k)
        assert err <= allow + slack, (k, err, allow, slack)
    print(f"against JAX: the one-process step over the bounds at {over}")
