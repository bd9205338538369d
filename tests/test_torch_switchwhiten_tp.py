"""SwitchWhiten and the whitening loss under tensor parallelism on the CPU:
the channels split over the model axis of a (data, model, spatial) mesh of
gloo ranks (``core/mesh.py``, ``weights.shard_model``), against one process
on the whole map.

Two process groups (``torch_dist_group.Group``: file rendezvous, gloo, one
torch thread a rank) run the cases of ``torch_zoo_tensor_parallel_cases.py``:
a world of 2 on a (1, 2, 1) mesh, and a world of 4 on a (2, 2, 1) mesh
(two data ranks of two model ranks) and a (1, 2, 2) mesh (two model ranks,
each of two bands of rows).

- ``SwitchWhiten2d`` of 64 channels at M = 2 (4 groups of 16: each rank
  whitens its own 2, the local path) and of 48 channels (3 groups: one
  straddles the ranks, and every rank whitens the gathered map whole),
  types 2, 3 and 5, in train and in eval mode, fp64: the output, the
  input's gradient and every parameter's (summed over the replica group,
  the shards gathered) within 1e-12 of their largest value from one
  process's; the mixing weights' gradients whole and equal on every rank;
  the running buffers after the step one process's within 1e-12; the
  buffers cut by group on the local path and whole on the straddling one.
- ``instance_whitening_loss`` with masks over two maps at M = 2, each
  gathered whole from the ranks' slices, fp64: the loss and each slice's
  gradient within 1e-12 of one process's.
"""

import numpy as np
import pytest
import torch

from mrfp_tpu_torch.nn.norms import SW_PERGROUP

import torch_zoo_tensor_parallel_cases as cases
from torch_dist_group import Group

torch.set_num_threads(2)

SW_TYPES = (2, 3, 5)
WIDTHS = {"local": 64, "straddling": 48}
MESHES = {"1x2x1": (1, 2, 1), "2x2x1": (2, 2, 1), "1x2x2": (1, 2, 2)}  # (dp, mp, sp)
MIXING = ("d_sw_mean_weight", "d_sw_var_weight")


def _tensor(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


def _sw_state(seed: int, features: int, sw_type: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    g = features // SW_PERGROUP
    m = 0.3 * torch.randn(g, SW_PERGROUP, SW_PERGROUP, generator=gen, dtype=torch.float64)
    return {"sw_mean_weight": torch.randn(sw_type, generator=gen, dtype=torch.float64),
            "sw_var_weight": torch.randn(sw_type, generator=gen, dtype=torch.float64),
            "weight": 1 + 0.1 * torch.randn(features, generator=gen, dtype=torch.float64),
            "bias": 0.1 * torch.randn(features, generator=gen, dtype=torch.float64),
            "running_mean": 0.1 * torch.randn(g, SW_PERGROUP, 1, generator=gen,
                                              dtype=torch.float64),
            "running_cov": (torch.eye(SW_PERGROUP, dtype=torch.float64)
                            + m @ m.transpose(1, 2) / SW_PERGROUP)}


def _sw_kwargs(c: int, t: int, train: bool) -> dict:
    x = 0.5 + _tensor(40 + c + t, (4, c, 7, 6))
    return dict(x=x, dy=_tensor(50 + c + t, x.shape), sw_type=t, sd=_sw_state(t, c, t),
                train=train)


def _wtloss_kwargs() -> dict:
    maps = [1.0 + _tensor(300, (3, 16, 9, 7)), _tensor(301, (3, 32, 5, 5))]
    rng = np.random.default_rng(302)
    masks = [torch.from_numpy(np.triu(rng.random((c, c)) < 0.4, 1).astype(np.float64))
             for c in (16, 32)]
    return dict(maps=maps, masks=masks, nrc=[float(m.sum()) for m in masks])


def _sw_name(path: str, t: int, mode: str, mesh: str) -> str:
    return f"sw_{path}_{t}_{mode}_{mesh}"


def _jobs(world: int) -> dict:
    jobs = {}
    for mesh, (dp, mp, sp) in MESHES.items():
        if dp * mp * sp != world:
            continue
        for path, c in WIDTHS.items():
            for t in SW_TYPES:
                for mode in ("train", "eval"):
                    jobs[_sw_name(path, t, mode, mesh)] = (
                        "sw_case", dict(_sw_kwargs(c, t, mode == "train"), dp=dp, mp=mp, sp=sp))
    if world == 2:
        jobs["wtloss"] = ("wtloss_case", dict(_wtloss_kwargs(), mp=2))
    return jobs


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    out = {w: Group(_jobs(w), tmp_path_factory.mktemp(f"sw_tp{w}"),
                    cases="torch_zoo_tensor_parallel_cases", world=w) for w in (2, 4)}
    yield out
    for g in out.values():
        g.close()


def _rel_close(got, want, tol: float, what) -> None:
    err = float((got - want).abs().max())
    scale = max(1e-30, float(want.abs().max()))
    assert err <= tol * scale, (what, err, tol * scale)


def _joined(got: list, k: str, dp: int, mp: int, sp: int) -> torch.Tensor:
    """The ranks' parts of a map joined, rank ``(d mp + m) sp + s``: bands of
    rows (dim 2) within a spatial group, channel slices (dim 1) within a
    model group, the data ranks' samples (dim 0) after."""
    return torch.cat([torch.cat([torch.cat([got[(d * mp + m) * sp + s][k] for s in range(sp)],
                                           dim=2) for m in range(mp)], dim=1)
                      for d in range(dp)], dim=0)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("path", sorted(WIDTHS))
def test_switchwhiten_on_channel_slices_is_the_whole_layer(groups, path, mode, mesh):
    """``SwitchWhiten2d`` types 2, 3 and 5 with the channels split over a
    model group of 2 (the local path, 64 channels, or the straddling one,
    48), on a (1, 2, 1), (2, 2, 1) or (1, 2, 2) mesh (on the last each rank
    also holds a band of rows: the IW and LN statistics combine over the
    spatial group too, the LN ones over the model group), against one
    process on the whole batch, fp64 (the module's docstring has the
    bounds)."""
    dp, mp, sp = MESHES[mesh]
    world = dp * mp * sp
    c = WIDTHS[path]
    for t in SW_TYPES:
        name = _sw_name(path, t, mode, mesh)
        got = groups[world].take(name)
        one = cases.sw_case(**groups[world].job[name][1] | dict(dp=1, mp=1, sp=1))
        for k in ("out", "dx"):
            _rel_close(_joined(got, k, dp, mp, sp), one[k], 1e-12, (name, k))
        for k, v in one.items():
            if k in ("out", "dx", "shapes"):
                continue
            for res in got:
                _rel_close(res[k], v, 1e-12, (name, k))
        for k in MIXING:
            assert all(torch.equal(res[k], got[0][k]) for res in got), (name, k)
        g = c // SW_PERGROUP
        cut = g // mp if path == "local" else g
        for res in got:
            assert res["shapes"]["sw.running_cov"] == (cut, SW_PERGROUP, SW_PERGROUP), name
            assert res["shapes"]["sw.weight"] == (c // mp,), name
            assert res["shapes"]["sw.sw_mean_weight"] == ((t // mp,) if t % mp == 0 else (t,))


def test_whitening_loss_of_gathered_slices_is_one_process_s(groups):
    """``instance_whitening_loss`` with masks over two maps (16 and 32
    channels) whose channels two ranks hold half each, each map gathered
    whole, against one process, fp64: the loss on every rank and each
    slice's gradient within 1e-12."""
    got = groups[2].take("wtloss")
    kwargs = groups[2].job["wtloss"][1]
    one = cases.wtloss_case(**kwargs | dict(mp=1))
    for res in got:
        _rel_close(res["loss"], one["loss"], 1e-12, "loss")
    for i in range(len(kwargs["maps"])):
        _rel_close(torch.cat([res["dx"][i] for res in got], dim=1), one["dx"][i], 1e-12,
                   ("dx", i))
