"""The port's weight paths: the JAX variable tree mapped to the port's
state_dict, and the reference .pth container read back, both loading into
the port's MRFP with strict=True."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.train.export_torch import export_state_dict
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.weights import load_torch_checkpoint, state_dict_from_jax

from torch_oracle import make_reference_state_dict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_tree():
    sd = make_reference_state_dict(seed=0)
    model = JaxMRFP(trunk="resnet-50", variant="D16")
    variables = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), variables)
    params, stats, _oc, report = convert_state_dict(sd, variables)
    assert report["skipped"] == []
    return sd, params, stats


def test_state_dict_from_jax_equals_export(jax_tree):
    _sd, params, stats = jax_tree
    got = state_dict_from_jax(params, stats)
    ref = {k: v for k, v in export_state_dict(params, stats, module_prefix=False).items()
           if not k.split(".")[0].startswith("OC")}
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_state_dict_from_jax_loads_strict_and_matches_reference(jax_tree):
    sd, params, stats = jax_tree
    port = MRFP()
    result = port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # the same numbers as the reference container (nbt is reset to 0)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd["module." + k]), k


def test_pth_loader_round_trips_and_drops_oc(jax_tree, tmp_path):
    sd = jax_tree[0]
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "state_dict": sd}, path)
    port = MRFP()
    report = load_torch_checkpoint(port, str(path))
    oc = sorted(k[len("module."):] for k in sd if k.startswith("module.OC"))
    assert len(oc) == 8 * 2 + 8 * 5  # 8 convs (weight, bias), 8 BNs (5 each)
    assert report["dropped"] == oc
    assert report["loaded"] == len(sd) - len(oc)
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd["module." + k]), k


def test_pth_loader_refuses_missing_keys(jax_tree, tmp_path):
    sd = dict(jax_tree[0])
    del sd["module.final2.0.bias"]
    path = tmp_path / "bad.pth"
    torch.save({"epoch": 0, "state_dict": sd}, path)
    with pytest.raises(RuntimeError, match="final2.0.bias"):
        load_torch_checkpoint(MRFP(), str(path))
