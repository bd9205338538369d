"""The port's RobustNet zoo (``nn/cov_settings.py``, ``models/deepv3_zoo.py``,
``train/losses.py::instance_whitening_loss``, ``train/zoo_step.py``) against
the JAX package on the CPU, one JAX variable tree driving both through
``state_dict_from_jax``.

Bounds: ``kmeans_1d`` and the masks from one variance matrix bit-equal (a
copy of the same host code); from the same maps, the variance of
covariance within 1e-5 of its scale (the port takes it in fp64 on the
map's device, JAX in fp32 numpy) and the masks bit-equal with equal
counts; from each package's own maps, the masks agree on 99.9% of entries
with equal counts; the whitening loss within 1e-5 relative; DeepV3Plus
r18-D32 ``wt_layer`` 0022200 at 64 px: eval logits atol 5e-4 rtol 1e-3,
train logits and DSN logits within 0.05 and the maps within 1e-3 of their
scale (the train-forward bounds of tests/test_torch_train.py); one fp32
zoo step at lr 1 with JAX's dropout mask: loss within 5e-4, BN statistics
2e-3, every raw gradient 1e-2 of its norm (norm scales 5e-2), on the
damped fixture (ROADMAP C3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import Config as JaxConfig
from mrfp_tpu.models import deepv3_zoo as jax_zoo
from mrfp_tpu.nn import cov_settings as jax_cov
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import losses as jax_losses
from mrfp_tpu.train.zoo_step import zoo_train_step as jax_zoo_train_step
from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.models import deepv3_zoo
from mrfp_tpu_torch.nn import cov_settings
from mrfp_tpu_torch.train import losses
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step
from mrfp_tpu_torch.weights import state_dict_from_jax

from torch_port_fixture import assert_step_matches
from torch_zoo_fixture import jax_vars, nchw, nhwc, random_variables

torch.set_num_threads(2)

WT = (0, 0, 2, 2, 2, 0, 0)
HW = 64


def test_kmeans_1d_is_the_jax_copy():
    rng = np.random.default_rng(0)
    v = np.concatenate([np.zeros(300), rng.gamma(2.0, 1e-3, 700)]).astype(np.float32)
    for k in (5, 50):
        a_j, c_j = jax_cov.kmeans_1d(v, k)
        a_p, c_p = cov_settings.kmeans_1d(v, k)
        np.testing.assert_array_equal(a_p, a_j)
        np.testing.assert_array_equal(c_p, c_j)


def _maps(seed: int, n: int = 4, c: int = 16, hw=(6, 5)):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((1, *hw, c))
    return (base + 0.5 * rng.standard_normal((n, *hw, c))).astype(np.float32)


@pytest.mark.parametrize("relax_denom", [0.0, 4.0])
def test_isw_masks_from_the_same_maps_are_bit_equal(relax_denom):
    """Two accumulation steps of the same NHWC maps into each package's
    CovMatrixISW (the port's ``covstat_update`` takes the NCHW view)."""
    jl = jax_cov.CovMatrixISW(dim=16, relax_denom=relax_denom, clusters=5)
    pl = cov_settings.CovMatrixISW(dim=16, relax_denom=relax_denom, clusters=5)
    for seed in (1, 2):
        m = _maps(seed)
        jax_zoo.covstat_update([jl], [m])
        deepv3_zoo.covstat_update([pl], [nchw(m)])
    scale = float(np.abs(jl.var_matrix).max())
    assert np.abs(pl.var_matrix - jl.var_matrix).max() <= 1e-5 * scale
    # the same variance matrix through both copies: bit-equal by construction
    same = cov_settings.CovMatrixISW(dim=16, relax_denom=relax_denom, clusters=5)
    same.var_matrix, same.count_var_cov = jl.var_matrix.copy(), jl.count_var_cov
    _e, want, want_margin, want_nrc = jl.get_mask_matrix()
    for layer in (pl, same):
        _e, got, margin, nrc = layer.get_mask_matrix()
        np.testing.assert_array_equal(got, want)
        assert (margin, nrc) == (want_margin, want_nrc) and nrc > 0


def test_isw_masks_of_upper_triangular_variances_are_jax_s_quirk_and_all():
    """ROADMAP C10: a statistics pass's variance matrix is zero on and
    below the diagonal, more than half of its entries, so ``kmeans_1d``'s
    quantile start duplicates the zero centroid; every non-zero entry then
    counts as sensitive and, as the unstable argsort orders the tied zero
    centroids, the zeros too (the count C * C). The port's copy gives JAX's
    mask in either case."""
    counts = set()
    for seed in range(6):
        var = np.triu(np.random.default_rng(seed).gamma(2.0, 1e-4, (64, 64)), 1)
        masks = []
        for module in (jax_cov, cov_settings):
            layer = module.CovMatrixISW(dim=64, clusters=50)
            layer.set_variance_of_covariance(var.astype(np.float32))
            layer.set_mask_matrix()
            masks.append(layer.get_mask_matrix())
        np.testing.assert_array_equal(masks[1][1], masks[0][1])
        assert masks[1][3] == masks[0][3]
        counts.add(masks[0][3])
    assert counts == {64 * 63 / 2, 64 * 64}


@pytest.mark.parametrize("relax_denom", [0.0, 4.0])
def test_irw_masks_match_and_take_no_statistics_pass(relax_denom):
    """IRW's fixed mask and margin equal JAX's. Neither package's IRW layer
    has ``set_variance_of_covariance``: JAX's statistics pass fails on it
    with an AttributeError, the port's with its own message (ROADMAP C6)."""
    jl = jax_cov.CovMatrixIRW(dim=8, relax_denom=relax_denom)
    pl = cov_settings.CovMatrixIRW(dim=8, relax_denom=relax_denom)
    for a, b in zip(jl.get_mask_matrix(), pl.get_mask_matrix()):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    m = _maps(3, c=8)
    with pytest.raises(AttributeError, match="set_variance_of_covariance"):
        jax_zoo.covstat_update([jl], [m])
    with pytest.raises(ValueError, match="ROADMAP C6"):
        deepv3_zoo.covstat_update([pl], [nchw(m)])


@pytest.mark.parametrize("case", ["upper", "masks_scalar_margin", "masks_per_layer_margin"])
def test_instance_whitening_loss_matches_jax(case):
    rng = np.random.default_rng(4)
    maps = [_maps(5, c=8), _maps(6, c=16, hw=(4, 7))]
    masks = nrc = None
    margin = 0.0
    if case != "upper":
        masks = [(rng.random((c, c)) < 0.3).astype(np.float32) for c in (8, 16)]
        nrc = [float(m.sum()) for m in masks]
        margin = [0.5, 1.5] if case == "masks_per_layer_margin" else 0.25
    want = float(jax_losses.instance_whitening_loss(
        [jnp.asarray(m) for m in maps], None if masks is None else
        [jnp.asarray(m) for m in masks], margin, nrc))
    got = losses.instance_whitening_loss([nchw(m) for m in maps], masks, margin, nrc)
    assert got.dtype == torch.float32 and want > 0
    assert abs(float(got) - want) <= 1e-5 * want, (float(got), want)


def test_factory_names_are_jax_s_and_other_trunks_raise():
    """The 23 factory names and their (trunk, variant) are JAX's, every
    one builds (tests/test_torch_zoo_trunks.py holds their keys), and an
    unknown name raises."""
    # JAX's registry also picks up the imported DeepLabDecoder class (its
    # filter is "a callable whose name starts with Deep"): not a factory
    assert sorted(deepv3_zoo.FACTORIES) == sorted(set(jax_zoo.MODEL_REGISTRY) -
                                                  {"DeepLabDecoder"})
    for name, (trunk, variant) in deepv3_zoo.FACTORIES.items():
        probe = jax_zoo.MODEL_REGISTRY[name]()
        assert (probe.trunk, probe.variant) == (trunk, variant), name
        assert trunk in deepv3_zoo.SLOT_CHANNELS
    assert len(deepv3_zoo.FACTORIES) == 23 and len(deepv3_zoo.SLOT_CHANNELS) == 15
    net = deepv3_zoo.get_net("DeepR18V3PlusD", wt_layer=WT)
    assert (net.trunk, net.variant, net.wt_layer, net.use_dsn) == ("resnet-18", "D", WT, True)
    with pytest.raises(ValueError, match="unknown arch"):
        deepv3_zoo.get_net("DeepR18V3PlusE")
    for trunk, channels in deepv3_zoo.SLOT_CHANNELS.items():
        assert jax_zoo._TRUNKS[trunk]["in_ch"] == channels


@pytest.fixture(scope="module")
def r18():
    """r18-D32, ``wt_layer`` 0022200, the DSN head: JAX's model and one
    damped random tree, and the port's model with it, in train mode."""
    jmodel = jax_zoo.DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=WT, use_dsn=True)
    params, stats = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32), seed=2,
                                     damp=True, train=False)
    return jmodel, params, stats


def _port(r18):
    _jmodel, params, stats = r18
    model = deepv3_zoo.DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=WT, use_dsn=True)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return model


def _keep_mask(jmodel, variables, img, key) -> torch.Tensor:
    """JAX's DSN dropout keep mask for ``key``, read back from the
    dropout's output (a 0 there was dropped, or was 0 before it, where the
    mask changes nothing)."""
    _out, mut = jmodel.apply(variables, jnp.asarray(img), train=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True, rngs={"dropout": key})
    return nchw(np.asarray(mut["intermediates"]["dsn"]["Dropout_0"]["__call__"][0]) != 0)


def _batch(b: int = 4, seed: int = 7):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (b, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    return img, lbl


def test_deepv3plus_r18_d32_train_and_eval_match_jax(r18):
    jmodel, params, stats = r18
    variables = jax_vars(params, stats)
    img, _ = _batch(2)
    key = jax.random.PRNGKey(8)
    out, _ = jmodel.apply(variables, jnp.asarray(img), train=True, mutable=["batch_stats"],
                          rngs={"dropout": key})
    port = _port(r18).train()
    with torch.no_grad():
        got = port(nchw(img), dropout=_keep_mask(jmodel, variables, img, key))
    assert sorted(got) == ["dsn", "logits", "w_arr"]
    assert got["logits"].dtype == got["dsn"].dtype == torch.float32
    assert got["dsn"].shape == (2, 19, HW // 16, HW // 16)  # layer3: stride 16
    for k in ("logits", "dsn"):
        err = np.abs(nhwc(got[k]) - np.asarray(out[k])).max()
        assert err < 0.05, (k, err)
    # the stem map (before its ReLU and max pool), then layer1's and layer2's
    assert [tuple(w.shape) for w in got["w_arr"]] == [(2, 64, 32, 32), (2, 64, 16, 16),
                                                      (2, 128, 8, 8)]
    for a, b in zip(got["w_arr"], out["w_arr"]):
        b = np.asarray(b)
        assert np.abs(nhwc(a) - b).max() <= 1e-3 * np.abs(b).max()
    port = _port(r18).eval()  # the train forward moved the running statistics
    with torch.no_grad():
        w_only = port(nchw(img), cal_covstat=True)
        logits = port(nchw(img))
    assert sorted(w_only) == ["w_arr"] and len(w_only["w_arr"]) == 3
    assert isinstance(logits, torch.Tensor) and logits.dtype == torch.float32
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img), train=False)["logits"])
    np.testing.assert_allclose(nhwc(logits), want, atol=5e-4, rtol=1e-3)
    assert (nhwc(logits).argmax(-1) == want.argmax(-1)).mean() > 0.999


def _view_pairs():
    rng = np.random.default_rng(9)
    return [tuple(rng.uniform(0, 255, (2, HW, HW, 3)).astype(np.float32) for _ in range(2))
            for _ in range(2)]


def test_covstat_masks_from_each_package_s_own_maps(r18):
    """The statistics pass over two view pairs, each package on its own
    eval forward: the masks agree on 99.9% of entries, with equal counts."""
    from mrfp_tpu.train.zoo_step import covstat_pass as jax_covstat_pass
    jmodel, params, stats = r18
    pairs = _view_pairs()
    jl = jax_zoo.build_cov_layers("resnet-18", WT, clusters=5)
    want_masks, want_nrc = jax_covstat_pass(
        jmodel, jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, stats), jl,
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs])
    pl = deepv3_zoo.build_cov_layers("resnet-18", WT, clusters=5)
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    masks, nrc = covstat_pass(_port(r18), pl, pairs, cfg, torch.device("cpu"))
    assert [m.shape[0] for m in masks] == [64, 64, 128]
    assert nrc == want_nrc
    for got, want in zip(masks, want_masks):
        assert (got.numpy() == np.asarray(want)).mean() >= 0.999


def test_one_zoo_step_matches_jax(r18):
    """One fp32 zoo step (CE + 0.4 DSN CE + 0.6 ISW loss at margin 0) at
    batch 4 and lr 1 against JAX's ``zoo_train_step``: one set of masks
    (JAX's statistics pass) and JAX's dropout mask for its step-0 key go
    into the port."""
    from mrfp_tpu.train.zoo_step import covstat_pass as jax_covstat_pass
    jmodel, params, stats = r18
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, stats)
    jl = jax_zoo.build_cov_layers("resnet-18", WT, clusters=5)
    masks, nrc = jax_covstat_pass(jmodel, jp, js, jl, [
        (jnp.asarray(a), jnp.asarray(b)) for a, b in _view_pairs()])
    img, lbl = _batch()
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, use_wtloss=True),
                        train=dataclasses.replace(jcfg.train, lr=1.0))
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jp, batch_stats=js)
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)  # zoo_train_step's draw
    keep = _keep_mask(jmodel, jax_vars(params, stats), img, key)
    step = jax.jit(functools.partial(jax_zoo_train_step, model=jmodel, cfg=jcfg,
                                     wt_masks=masks, wt_nrc=nrc))
    jstate, m = step(jstate, jnp.asarray(img), jnp.asarray(lbl))
    assert float(m["loss_wt"]) > 0

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_wtloss=True),
                      train=dataclasses.replace(cfg.train, lr=1.0, compute_dtype="float32"))
    model = _port(r18)
    state = create_train_state(model, cfg.train)
    got = zoo_train_step(state, torch.from_numpy(img), torch.from_numpy(lbl), cfg,
                         [torch.from_numpy(np.array(k)) for k in masks], nrc, dropout=keep)
    for k in ("loss", "loss_main", "loss_aux", "loss_wt"):
        assert abs(float(got[k]) - float(m[k])) < 5e-4, (k, float(got[k]), float(m[k]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    assert_step_matches(state_dict_from_jax(params, stats), after, model, 1.0,
                        cfg.train.weight_decay)
    assert state.step == 1
