"""The port's training extras (CPU, plain kernels) against the JAX package:
the border-relaxed CE and its target, batch class weights, the FFT batch
transforms, gradient reversal, the matchstick ``inject``, the DSN head and
its weights, and one fp32 train step with each extra against JAX's
``train_step``.

Bounds: the relaxed target bit-equal; the relaxed CE of each package
within 2e-6 relative of the same formula in fp64 (the port's function on
float64 logits), and JAX's against the port's within the sum of those two
distances plus 1e-7; the class weights within 1e-6 relative; HPF/LPF within atol 1e-2 and PHOT within atol 2e-2,
rtol 1e-3 (tests/test_fft_style.py); the DSN model's train logits and aux
logits within 0.05 and its losses within 5e-4 (the train-forward bounds of
tests/test_torch_train.py); a step's loss within 5e-4 and every raw
gradient within 1e-2 of its norm (norm scales 5e-2) on the damped fixture
(ROADMAP C3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import baseline_config as jax_baseline_config
from mrfp_tpu.core.rng import step_keys
from mrfp_tpu.nn.grad_reversal import grad_reverse as jax_grad_reverse
from mrfp_tpu.perturb.fft_style import apply_freq_transform as jax_freq_transform
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train import losses as jax_losses
from mrfp_tpu.train.state import lr_schedule
from mrfp_tpu_torch.core.config import baseline_config
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.nn.grad_reversal import grad_reverse
from mrfp_tpu_torch.perturb.fft_style import apply_freq_transform
from mrfp_tpu_torch.train import losses
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step
from mrfp_tpu_torch.weights import load_torch_checkpoint, state_dict_from_jax

from torch_port_fixture import (assert_step_matches, dsn_keep_mask, jax_vars, nchw,
                                port_model, reference)

torch.set_num_threads(2)

HW = 48
C = 19


def _skewed_labels(rng, shape):
    """Class k drawn with probability ~ 1/(k+1), a tenth of the pixels
    ignore: a histogram the class weights can tell apart."""
    p = 1.0 / np.arange(1, C + 1)
    lbl = rng.choice(C, size=shape, p=p / p.sum())
    lbl[rng.random(shape) < 0.1] = 255
    return lbl.astype(np.int32)


@pytest.mark.parametrize("strict", [None, (3, 7)])
@pytest.mark.parametrize("reduce_now", [False, True])
@pytest.mark.parametrize("border", [1, 2])
def test_relaxed_multihot_is_bit_equal_to_jax(border, reduce_now, strict):
    lbl = _skewed_labels(np.random.default_rng(5), (2, 16, 20))
    lbl[1, 4:9, 4:9] = 255
    allowed, weight = jax_losses.relaxed_multihot(jnp.asarray(lbl), C, 255, border,
                                                  jnp.asarray(reduce_now), strict)
    got_a, got_w = losses.relaxed_multihot(torch.from_numpy(lbl), C, 255, border,
                                           reduce_now, strict)
    assert got_a.dtype == torch.bool and got_w.dtype == torch.float32
    np.testing.assert_array_equal(np.moveaxis(got_a.numpy(), 1, -1), np.asarray(allowed))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(weight))


@pytest.mark.parametrize("strict", [None, (0,)])
@pytest.mark.parametrize("reduce_now", [False, True])
@pytest.mark.parametrize("border", [1, 2])
def test_relaxed_cross_entropy_matches_jax(border, reduce_now, strict):
    rng = np.random.default_rng(border * 10 + reduce_now)
    lbl = _skewed_labels(rng, (2, 16, 20))
    lbl[0, :6, :6] = 255  # an ignore block whose inner pixels allow no class
    logits = rng.standard_normal((2, 16, 20, C)).astype(np.float32)
    want = float(jax_losses.relaxed_cross_entropy(
        jnp.asarray(logits), jnp.asarray(lbl), C, 255, border, jnp.asarray(reduce_now),
        strict))
    x = nchw(logits).requires_grad_(True)
    got = losses.relaxed_cross_entropy(x, torch.from_numpy(lbl), C, 255, border,
                                       reduce_now, strict)
    got.backward()
    # the bound is grounded in fp64: a 640-pixel fp32 mean lies a few ulps
    # from it, by the summation order of the machine that runs it
    exact = float(losses.relaxed_cross_entropy(nchw(logits).double(), torch.from_numpy(lbl),
                                               C, 255, border, reduce_now, strict))
    d_port = abs(float(got.detach()) - exact) / abs(exact)
    d_jax = abs(want - exact) / abs(exact)
    assert d_port <= 2e-6 and d_jax <= 2e-6, (d_port, d_jax)
    assert abs(float(got.detach()) - want) / abs(exact) <= d_port + d_jax + 1e-7
    assert torch.isfinite(x.grad).all()


def test_relaxed_cross_entropy_at_border_0_is_cross_entropy():
    rng = np.random.default_rng(1)
    lbl = _skewed_labels(rng, (2, 8, 8))
    logits = torch.from_numpy(rng.standard_normal((2, C, 8, 8)).astype(np.float32))
    a = losses.relaxed_cross_entropy(logits, torch.from_numpy(lbl), C, 255, 0, False)
    b = losses.cross_entropy(logits, torch.from_numpy(lbl), 255)
    assert abs(float(a) - float(b)) <= 1e-6 * float(b)


def test_batch_class_weights_match_jax():
    rng = np.random.default_rng(2)
    lbl = _skewed_labels(rng, (4, 16, 16))
    lbl[0, 0, :3] = (19, 40, 254)  # outside [0, C): counted nowhere
    want = np.asarray(jax_losses.batch_class_weights(jnp.asarray(lbl), C, 255))
    got = losses.batch_class_weights(torch.from_numpy(lbl), C, 255).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.min() >= 1.0 and got.max() <= 2.0 and got[0] < got[C - 1]
    logits = rng.standard_normal((4, 16, 16, C)).astype(np.float32)
    lbl[0, 0, :3] = 255
    want_ce = float(jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(lbl), 255,
                                             jnp.asarray(want)))
    got_ce = float(losses.cross_entropy(nchw(logits), torch.from_numpy(lbl), 255,
                                        torch.from_numpy(got)))
    # the weighted CE's own bound (tests/test_torch_train.py)
    assert abs(got_ce - want_ce) < 1e-5


def test_batch_class_weights_of_an_all_ignore_batch_are_one():
    w = losses.batch_class_weights(torch.full((2, 4, 4), 255), C, 255)
    assert torch.equal(w, torch.ones(C))


@pytest.mark.parametrize("kind,atol,rtol", [("hpf", 1e-2, 0), ("lpf", 1e-2, 0),
                                            ("phot", 2e-2, 1e-3)])
def test_freq_transform_matches_jax(kind, atol, rtol):
    batch = np.random.default_rng(0).uniform(0, 255, (2, 40, 48, 3)).astype(np.float32)
    want = np.asarray(jax_freq_transform(jnp.asarray(batch), kind))
    got = apply_freq_transform(torch.from_numpy(batch), kind)
    assert got.dtype == torch.float32 and got.shape == batch.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


def test_hpf_and_lpf_drop_the_ring_at_the_radius():
    """d^2 == r^2 is kept by neither filter: on a 32x32 grid, where such
    points exist, HPF + LPF does not give the image back."""
    img = np.random.default_rng(1).uniform(0, 255, (1, 32, 32, 3)).astype(np.float32)
    x = torch.from_numpy(img)
    ring = x - (apply_freq_transform(x, "hpf") + apply_freq_transform(x, "lpf"))
    assert float(ring.abs().max()) > 1e-3
    with pytest.raises(ValueError, match="freq_transform"):
        apply_freq_transform(x, "fft")


def test_grad_reverse_matches_jax():
    v = np.random.default_rng(3).standard_normal(5).astype(np.float32)
    w = np.random.default_rng(4).standard_normal(5).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jax_grad_reverse(x, 2.5) * w))(
        jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_(True)
    y = grad_reverse(x, 2.5)
    (y * torch.from_numpy(w)).sum().backward()
    assert torch.equal(y.detach(), torch.from_numpy(v))
    np.testing.assert_array_equal(x.grad.numpy(), want)


@pytest.fixture(scope="module")
def ref():
    return reference(seed=13, hw=32)


@pytest.mark.parametrize("block,site", [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1), (2, 2)])
def test_matchstick_inject_matches_jax(ref, block, site):
    """layer1 with a perturbation routed into one block, at each site of
    each block (block 0 has the downsample, which reads the unperturbed x),
    eval mode, against the JAX stage (tests/test_matchstick.py's bounds)."""
    jmodel = ref[1]
    rng = np.random.default_rng(block * 2 + site)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    bound = jmodel.bind(jax_vars(ref), mutable=["batch_stats"])
    xp = bound.backbone.stem(jnp.asarray(img), [], False)
    c = 64 if site == 2 or block == 0 else 256
    v = 0.3 * rng.standard_normal((2, xp.shape[1], xp.shape[2], c)).astype(np.float32)
    want = np.asarray(bound.backbone.stage(0, xp, [], False, inject=(block, site,
                                                                     jnp.asarray(v))))
    port = port_model(ref).eval()
    with torch.no_grad():
        got = port.layer1(nchw(xp), inject=(block, site, nchw(v)))
        plain = port.layer1(nchw(xp))
    np.testing.assert_allclose(np.transpose(got.numpy(), (0, 2, 3, 1)), want,
                               rtol=1e-4, atol=1e-4)
    assert float((got - plain).abs().max()) > 1e-3  # the injection acted


@pytest.mark.parametrize("site", [1, 2])
def test_fused_block_honours_inject(ref, site):
    """The fuse_bn_stats train forward of a block takes the same ``inject``
    as the unfused one (both on their plain versions here; one-pass against
    two-pass variance, so within 1e-4)."""
    from mrfp_tpu_torch.ops.dot_stats import bn_stats_fusion
    port = port_model(ref)
    block = port.layer1[0]
    rng = np.random.default_rng(site)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8, 8)).astype(np.float32))
    v = torch.from_numpy(0.3 * rng.standard_normal((2, 64, 8, 8)).astype(np.float32))
    with torch.no_grad():
        unfused = block(x, inject=(site, v))
        with bn_stats_fusion("plain"):
            fused = block(x, inject=(site, v))
    torch.testing.assert_close(fused, unfused, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref_dsn():
    return reference(seed=11, use_dsn=True, damped=True, hw=HW)


def test_dsn_weights_map_and_load(ref_dsn, tmp_path):
    """The JAX tree's ``dsn`` maps to ``dsn.0`` / ``dsn.1`` / ``dsn.4`` and
    matches the reference state_dict it came from; a checkpoint with the
    head loads into an eval model without it, the head's tensors dropped
    and reported."""
    sd = ref_dsn[0]
    mapped = state_dict_from_jax(ref_dsn[2], ref_dsn[3])
    dsn = sorted(k for k in mapped if k.startswith("dsn."))
    assert dsn == sorted(k[len("module."):] for k in sd if k.startswith("module.dsn."))
    for k in dsn:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(mapped[k], sd["module." + k]), k
    with_head = MRFP(use_dsn=True)
    with_head.load_state_dict(mapped, strict=True)
    path = tmp_path / "step_1.pt"
    torch.save({"model": with_head.state_dict()}, path)
    report = load_torch_checkpoint(MRFP(), str(path))
    assert sorted(report["dropped"]) == dsn
    again = MRFP(use_dsn=True)
    assert load_torch_checkpoint(again, str(path))["dropped"] == []
    assert torch.equal(again.dsn[4].weight, with_head.dsn[4].weight)


def test_dsn_train_forward_matches_jax(ref_dsn):
    """Train logits and fp32 aux logits of MRFP(use_dsn=True) against JAX's,
    with JAX's dropout mask injected; the eval forward returns the logits
    alone."""
    jmodel = ref_dsn[1]
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, HW, HW, 3)).astype(np.float32)
    lbl = _skewed_labels(rng, (2, HW, HW))
    key = jax.random.PRNGKey(8)
    out, _ = jmodel.apply(jax_vars(ref_dsn), jnp.asarray(img), train=True,
                          mutable=["batch_stats"], rngs={"dropout": key})
    mask = dsn_keep_mask(jmodel, jax_vars(ref_dsn), img, key)
    port = port_model(ref_dsn, use_dsn=True)
    with torch.no_grad():
        logits, aux = port(nchw(img), dropout=mask)
    assert aux.dtype == torch.float32 and aux.shape == (2, C, HW // 16, HW // 16)
    for got, want in ((logits, out["logits"]), (aux, out["dsn"])):
        err = np.abs(np.transpose(got.numpy(), (0, 2, 3, 1)) - np.asarray(want)).max()
        assert err < 0.05, err
    lbl_s = lbl[:, ::16, ::16]  # nearest at 48 -> 3 reads rows 0, 16, 32
    want_aux = float(jax_losses.cross_entropy(out["dsn"], jnp.asarray(lbl_s), 255))
    got_aux = float(losses.cross_entropy(aux, torch.from_numpy(lbl_s), 255))
    assert abs(want_aux - got_aux) < 5e-4
    port.eval()
    with torch.no_grad():
        assert isinstance(port(nchw(img)), torch.Tensor)


def _extra_cfgs(extra: str):
    """(JAX config, port config, start step) for one extra on the baseline
    recipe in fp32."""
    data, model = {}, {}
    step = 0
    if extra == "hpf":
        data = dict(freq_transform="hpf")
    elif extra == "batch_weighting":
        data = dict(batch_weighting=True)
    elif extra == "jointwtborder":
        data = dict(jointwtborder=True, border_window=2)
    elif extra == "jointwtborder_reduced":
        # the step runs past reduce_border_iter: window 1, boundaries x2
        data = dict(jointwtborder=True, border_window=2, reduce_border_iter=2,
                    strict_border_class=(1,))
        step = 3
    elif extra == "dsn":
        model = dict(use_dsn_aux=True)
    out = []
    for c in (jax_baseline_config(), baseline_config()):
        c = c.replace(data=dataclasses.replace(c.data, **data),
                      model=dataclasses.replace(c.model, **model),
                      train=dataclasses.replace(c.train, lr=1.0))
        out.append(c)
    port_cfg = out[1].replace(train=dataclasses.replace(out[1].train,
                                                        compute_dtype="float32"))
    return out[0], port_cfg, step


@pytest.mark.parametrize("extra", ["hpf", "batch_weighting", "jointwtborder",
                                   "jointwtborder_reduced", "dsn"])
def test_one_step_with_each_extra_matches_jax(extra):
    """One baseline-recipe SGD step in fp32 with one extra on, batch 4, on
    the damped fixture, against the jitted JAX step: the loss within 5e-4,
    the BN running statistics within 2e-3, every raw gradient within 1e-2.
    For the DSN the port takes JAX's dropout mask.

    The rate is 1 in both packages, so that the gradient read back from
    JAX's fp32 update is exact to ~1e-7: at 0.01 a norm scale near 1 reads
    back only to 1.2e-5, 6% of the border-relaxed loss's layer4 scale
    gradients. The batch is tests/test_torch_train.py's, with the labels
    skewed toward low classes (the min of two uniform draws) so that the
    class weights differ. On other batches JAX's fp32 one-pass BN variance
    can put a BN whose mean is large beside its spread 1-3% off, where the
    port's fp32 and fp64 gradients agree within 1e-5 (ROADMAP C1)."""
    use_dsn = extra == "dsn"
    ref = reference(seed=11, use_dsn=use_dsn, damped=True, hw=HW, hrfp_plus=False)
    _sd, jmodel, params, stats, _ = ref
    jcfg, cfg, step = _extra_cfgs(extra)
    rng = np.random.default_rng(7)
    img = rng.standard_normal((4, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, C, (4, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    lbl = np.where(lbl == 255, 255, np.minimum(
        lbl, np.random.default_rng(8).integers(0, C, lbl.shape))).astype(np.int32)

    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                            step=jnp.asarray(step, jnp.int32))
    mask = None
    if use_dsn:
        mask = dsn_keep_mask(jmodel, jax_vars(ref), img,
                             step_keys(jstate.base_key, jstate.step)["dropout"])
    jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
    jstate, m = jtrain(jstate, jnp.asarray(img), jnp.asarray(lbl))

    state = create_train_state(port_model(ref, use_dsn=use_dsn), cfg.train)
    state.step = step
    start = state_dict_from_jax(params, stats)
    got = train_step(state, torch.from_numpy(img), torch.from_numpy(lbl), cfg, dropout=mask)
    assert abs(float(got["loss"]) - float(m["loss"])) < 5e-4, (float(got["loss"]),
                                                               float(m["loss"]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    lr = float(lr_schedule(jcfg.train)(step))
    assert_step_matches(start, after, state.model, lr, cfg.train.weight_decay)
    assert state.step == step + 1
