"""Gradient accumulation and the bf16 momentum of the port (CPU, plain
kernels).

- ``accum_steps=2`` against a hand-rolled loop of the port's own pieces
  (two forwards and backwards in turn, the mean gradient, one SGD step;
  loss 1e-6, BN statistics 1e-6, parameters within 1e-3 of the step they
  took, as tests/test_accum.py holds the JAX package), with the DSN head
  and per-microbatch draws injected;
- ``accum_steps=2`` of the MRFP+ recipe, all three gates on, against JAX's
  ``train_step(accum_steps=2)`` with its per-microbatch NP+ draws injected
  (loss 5e-4, BN statistics 2e-3, every raw gradient 1e-2 on the damped
  fixture, the bounds of tests/test_torch_train.py);
- the streams: without accumulation every role draws what it drew before
  accumulation existed; with it the NP+ and dropout streams fold in the
  microbatch and the gates stay once per step;
- ``momentum_dtype="bfloat16"`` against optax's ``trace`` with a bf16
  accumulator over 5 steps, the stored trace bit for bit, and through a
  checkpoint.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrfp_tpu.core.config import TrainConfig as JaxTrainConfig
from mrfp_tpu.core.config import mrfp_plus_config as jax_mrfp_plus_config
from mrfp_tpu.core.rng import step_keys
from mrfp_tpu.perturb.oc_branch import oc_maybe_resample as jax_oc_maybe_resample
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.state import lr_schedule
from mrfp_tpu.train.state import make_optimizer as jax_make_optimizer
from mrfp_tpu_torch.core.config import TrainConfig, mrfp_plus_config
from mrfp_tpu_torch.core.rng import ROLES, device_generator, role_seed
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.ops.resize import resize_nearest
from mrfp_tpu_torch.train.checkpoint import CheckpointManager
from mrfp_tpu_torch.train.losses import cross_entropy
from mrfp_tpu_torch.train.state import (SGDBf16Momentum, TrainState, create_train_state,
                                        make_optimizer)
from mrfp_tpu_torch.train.step import draw_perturb, train_step
from mrfp_tpu_torch.weights import state_dict_from_jax

from torch_port_fixture import assert_step_matches, np_draws, port_model, reference

torch.set_num_threads(2)

HW = 48


def _cfg(accum: int, **train):
    cfg = mrfp_plus_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, use_dsn_aux=train.pop("use_dsn", False)),
        train=dataclasses.replace(cfg.train, compute_dtype="float32", accum_steps=accum,
                                  **train))


def test_role_seeds_without_a_microbatch_are_unchanged():
    """accum_steps == 1 folds nothing: every stream keeps the seed it had
    (numpy's SeedSequence of (seed, step, role)); a microbatch index makes
    another stream for each microbatch."""
    for seed, step in ((0, 0), (3, 17)):
        for i, role in enumerate(ROLES):
            ss = np.random.SeedSequence([seed, step, i])
            want = int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
            assert role_seed(seed, step, role) == want
            folded = {role_seed(seed, step, role, mb) for mb in range(3)}
            assert len(folded) == 3 and want not in folded
    g = device_generator(3, 17, "dropout", "cpu", 1)
    assert torch.equal(torch.rand(4, generator=g), torch.rand(
        4, generator=torch.Generator().manual_seed(role_seed(3, 17, "dropout", 1))))


def test_accum_draws_gates_once_and_noise_per_microbatch():
    one = create_train_state(port_model(reference(hw=32), oc_branch=True, hrfp_plus=True),
                             TrainConfig())
    two = copy.deepcopy(one)
    p1 = draw_perturb(one, _cfg(1))
    p2 = draw_perturb(two, _cfg(2))
    assert (p1.gate_oc, p1.gate_np, p1.gate_dec) == (p2.gate_oc, p2.gate_np, p2.gate_dec)
    assert isinstance(p1.np0, torch.Generator) and len(p2.np0) == len(p2.np1) == 2
    draws = [torch.rand(3, generator=g) for g in (p1.np0, *p2.np0)]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])
    for k, v in one.model.state_dict().items():  # the same OC re-draw
        assert torch.equal(v, two.model.state_dict()[k]), k


def test_accum_rejects_an_indivisible_batch():
    state = create_train_state(port_model(reference(hw=32)), TrainConfig())
    img = torch.zeros((4, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not divisible"):
        train_step(state, img, torch.zeros((4, 32, 32), dtype=torch.uint8),
                   _cfg(3).replace(perturb=dataclasses.replace(_cfg(3).perturb,
                                                               enabled=False)))


def test_accum_matches_a_hand_rolled_loop():
    """accum_steps=2 with gates on and the DSN head: the step's loss, BN
    running statistics and parameters against two forwards and backwards
    of the port's model in turn (microbatch i takes images i, i+2, ...),
    the mean gradient and one SGD step."""
    ref = reference(seed=11, use_dsn=True, damped=True, hw=HW)
    cfg = _cfg(2, use_dsn=True)
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.standard_normal((4, HW, HW, 3)).astype(np.float32))
    lbl = torch.from_numpy(rng.integers(0, 19, (4, HW, HW)))
    lbl[1, :6] = 255
    gen = torch.Generator().manual_seed(5)
    draws = [[(1 + 0.75 * torch.randn(2, c, 1, 1, generator=gen),
               0.75 * torch.randn(2, c, 1, 1, generator=gen)) for _ in range(2)]
             for c in (64, 256)]
    masks = [torch.rand(2, 512, 3, 3, generator=gen) < 0.9 for _ in range(2)]
    perturb = PerturbArgs(True, True, True, draws[0], draws[1])

    model = port_model(ref, oc_branch=True, hrfp_plus=True, use_dsn=True)
    hand = copy.deepcopy(model)
    state = create_train_state(model, cfg.train)
    got = float(train_step(state, img, lbl, cfg, perturb=perturb, dropout=masks)["loss"])

    opt, _ = make_optimizer(hand, cfg.train)
    x = img.permute(0, 3, 1, 2).contiguous()
    losses = []
    for i in range(2):
        logits, aux = hand(x[i::2].contiguous(), dropout=masks[i], perturb=PerturbArgs(
            True, True, True, draws[0][i], draws[1][i]))
        small = resize_nearest(lbl[i::2, None].float(), size=aux.shape[2:])[:, 0].long()
        loss = cross_entropy(logits, lbl[i::2]) + 0.4 * cross_entropy(aux, small)
        loss.backward()
        losses.append(float(loss.detach()))
    before = {k: p.detach().clone() for k, p in hand.named_parameters()}
    for p in hand.parameters():
        p.grad /= 2
    opt.step()
    assert abs(got - sum(losses) / 2) <= 1e-6 * abs(got)
    want = hand.state_dict()
    for k, v in state.model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == int(want[k]), k
        elif k in before:
            moved = float((want[k] - before[k]).abs().max())
            err = float((v - want[k]).abs().max())
            assert err <= 1e-3 * moved + 1e-7, (k, err, moved)


def _all_gates_key():
    """A JAX base key whose step-0 gates all fire."""
    for k in range(200):
        key = jax.random.PRNGKey(k)
        u = np.asarray(jax.random.uniform(step_keys(key, 0)["gates"], (3,)))
        if (u < 0.5).all():
            return key
    raise AssertionError("no key found")


def test_accum_matches_jax():
    """accum_steps=2 of the MRFP+ recipe in fp32, batch 8, all gates on, on
    the damped fixture, against the jitted JAX step: its gates, its OC
    re-draw and each microbatch's NP+ draws (the NP+ keys folded with the
    microbatch index) are injected into the port. The rate is 1 in both,
    so the gradient read back from JAX's update is exact to ~1e-7."""
    ref = reference(seed=11, damped=True, hw=HW)
    _sd, jmodel, params, stats, oc = ref
    jcfg = jax_mrfp_plus_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, accum_steps=2, lr=1.0))
    cfg = _cfg(2, lr=1.0)
    rng = np.random.default_rng(7)
    img = rng.standard_normal((8, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (8, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255

    base_key = _all_gates_key()
    keys = step_keys(base_key, 0)
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3),
                                    oc_params=jax.tree_util.tree_map(jnp.asarray, oc))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                            base_key=base_key)
    jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
    jstate, m = jtrain(jstate, jnp.asarray(img), jnp.asarray(lbl))

    new_oc = jax_oc_maybe_resample(jax.tree_util.tree_map(jnp.asarray, oc), jnp.asarray(True),
                                   keys["oc_resample"], jcfg.perturb.oc_bn_std)
    new_oc = jax.tree_util.tree_map(np.asarray, new_oc)
    np0 = [np_draws(jax.random.fold_in(keys["np_l0"], i), 64, 4) for i in range(2)]
    np1 = [np_draws(jax.random.fold_in(keys["np_l1"], i), 256, 4) for i in range(2)]
    model = port_model(ref, oc_branch=True, hrfp_plus=True, oc=new_oc)
    state = create_train_state(model, cfg.train)
    got = train_step(state, torch.from_numpy(img), torch.from_numpy(lbl), cfg,
                     perturb=PerturbArgs(True, True, True, np0, np1))
    assert abs(float(got["loss"]) - float(m["loss"])) < 5e-4, (float(got["loss"]),
                                                               float(m["loss"]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    start = state_dict_from_jax(params, stats)
    assert_step_matches(start, after, model, float(lr_schedule(jcfg.train)(0)),
                        cfg.train.weight_decay)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 2, k  # one update per microbatch


def _optax_and_port(steps: int, seed: int = 0):
    """5 steps of JAX's bf16-trace SGD and of ``SGDBf16Momentum`` on the
    same random gradients; yields (JAX trace, port trace, JAX params, port
    params) after each step."""
    jcfg = dataclasses.replace(JaxTrainConfig(), momentum_dtype="bfloat16", max_iter=20)
    cfg = dataclasses.replace(TrainConfig(), momentum_dtype="bfloat16", max_iter=20)
    rng = np.random.default_rng(seed)
    shapes = [(64, 3, 7, 7), (64,), (19, 256, 1, 1)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_make_optimizer(jcfg)
    jp = [jnp.asarray(a) for a in p0]
    jst = tx.init(jp)
    module = torch.nn.Module()
    module.ps = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(a.copy()))
                                        for a in p0])
    opt, sched = make_optimizer(module, cfg)
    assert isinstance(opt, SGDBf16Momentum)
    for _ in range(steps):
        gs = [(rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for s in shapes]
        updates, jst = tx.update([jnp.asarray(g) for g in gs], jst, jp)
        jp = optax.apply_updates(jp, updates)
        for prm, g in zip(module.ps, gs):
            prm.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        yield ([np.asarray(t) for t in jst[1].trace],
               [opt.state[p]["momentum_buffer"] for p in module.ps],
               [np.asarray(p) for p in jp], [p.detach().numpy() for p in module.ps])


def test_bf16_momentum_matches_optax_bit_for_bit():
    """The stored trace equals optax's bit for bit over 5 steps; the
    parameters agree to the last bits of the rate (optax's schedule in
    fp32, LambdaLR's in fp64)."""
    for jtrace, trace, jp, p in _optax_and_port(5):
        for a, b in zip(jtrace, trace):
            assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
            np.testing.assert_array_equal(b.float().numpy(), a.astype(np.float32))
        for a, b in zip(jp, p):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_bf16_momentum_rounds_the_decay_to_bf16():
    """optax multiplies the weak-typed 0.9 by the bf16 trace in bf16, so the
    decay acts as 0.8984375: 0.9 * bf16(3.0) is 2.6875, not torch's
    ``t.mul(0.9)`` 2.703125."""
    t = torch.tensor([3.0], dtype=torch.bfloat16)
    assert float(jnp.asarray(3.0, jnp.bfloat16) * 0.9) == 2.6875
    assert float(t * float(torch.tensor(0.9, dtype=torch.bfloat16))) == 2.6875
    assert float(t.mul(0.9)) == 2.703125


def test_bf16_momentum_survives_a_checkpoint(tmp_path):
    cfg = dataclasses.replace(TrainConfig(), momentum_dtype="bfloat16", max_iter=20)

    def fresh():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8))
        opt, sched = make_optimizer(model, cfg)
        return TrainState(step=0, model=model, optimizer=opt, scheduler=sched, seed=0)

    def step(st, k):
        g = torch.Generator().manual_seed(k)
        for p in st.model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        st.optimizer.step()
        st.scheduler.step()
        st.step += 1

    one, two = fresh(), fresh()
    for k in range(2):
        step(one, k)
        step(two, k)
    ckpt = CheckpointManager(str(tmp_path), keep=1)
    ckpt.save(two)
    ckpt.wait()
    three = fresh()
    assert ckpt.restore(three) and three.step == 2
    ckpt.close()
    step(one, 2)
    step(three, 2)
    for p, q in zip(one.model.parameters(), three.model.parameters()):
        a = one.optimizer.state[p]["momentum_buffer"]
        b = three.optimizer.state[q]["momentum_buffer"]
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
        assert torch.equal(p, q)


def test_bf16_momentum_trains_the_model():
    cfg = _cfg(1)
    cfg = cfg.replace(perturb=dataclasses.replace(cfg.perturb, enabled=False),
                      train=dataclasses.replace(cfg.train, momentum_dtype="bfloat16"))
    state = create_train_state(port_model(reference(hw=32)), cfg.train)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    lbl = torch.from_numpy(rng.integers(0, 19, (2, 32, 32)))
    losses = [float(train_step(state, img, lbl, cfg)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses)) and state.step == 2
    bufs = [s["momentum_buffer"] for s in state.optimizer.state.values()]
    assert bufs and all(b.dtype == torch.bfloat16 for b in bufs)
