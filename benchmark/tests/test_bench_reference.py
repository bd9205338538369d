"""Each plain reference against the port at 64 px on the CPU, fp32: the
eval logits, and one train step's loss and gradients from the same
seed-made weights and inputs."""

import copy

import pytest
import torch

from benchmark import harness, inputs
from benchmark.drivers import train
from benchmark.reference import isw_r50_d16, mrfp_plus_r50_d16

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _cfg(name, n=4, side=64):
    cfg = copy.deepcopy(harness.load_json("configs", name))
    cfg["train"].update(batch_size=n, crop_size=side, compute_dtype="float32")
    return cfg


@pytest.mark.parametrize("name,ref", [("mrfp_plus_r50_d16", mrfp_plus_r50_d16),
                                      ("isw_r50_d16", isw_r50_d16)])
def test_eval_logits_match_the_port(name, ref):
    from benchmark.programs import mrfp
    cfg = _cfg(name)
    weights = inputs.weights(ref.template(cfg, False), SEED, CPU)
    if name == "mrfp_plus_r50_d16":
        model = mrfp.build_eval(cfg, weights, CPU)
    else:
        from benchmark.programs import zoo
        model = zoo._model(cfg).eval()
        model.load_state_dict(weights, strict=True)
    x = torch.rand(1, 3, 64, 128, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad():
        got = model(x)
    (want,) = list(ref.eval_logits(cfg, SEED, [x], CPU)) if hasattr(ref, "eval_logits") else \
        [_isw_eval(cfg, ref, x)]
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)


def _isw_eval(cfg, ref, x):
    model = ref.build(cfg, False)
    model.load_state_dict(inputs.weights(ref.template(cfg, False), SEED, CPU), strict=True)
    with torch.no_grad():
        return model(x)


@pytest.mark.parametrize("name", ["mrfp_plus_r50_d16", "isw_r50_d16"])
def test_first_train_step_matches_the_port(name):
    """The program's checked step against the reference's, fp32: the loss
    and each of its parts to 1e-5 and every kept leaf's gradient to 1e-4 of
    its scale; for ISW also the statistics pass: its variances to 1e-4, and
    the masks both of the reference's k-means of the program's variances
    and of the reference's own variances equal to the program's."""
    import importlib
    cfg = _cfg(name)
    traffic = harness.load_json("traffic", "train_window")
    cfg["model"]["covstat_batches"] = 2
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    program = importlib.import_module(f"benchmark.programs.{cfg['program']}")
    pool = inputs.pool(4 * traffic["pool_batches"], (64, 64), 19, traffic, SEED, CPU, False)
    trainer = program.Trainer(cfg, inputs.weights(ref.template(cfg, True), SEED, CPU), SEED,
                              CPU, pool)
    out = trainer.checked(*train.batch(pool, 0, 4, CPU), 0)
    prog = {"parts": [{k: float(v) for k, v in out.items() if k.startswith("loss")}],
            "grad": train.leaf_grads(trainer.state.model), **trainer.readings()}
    prog["change"] = prog["grad"]
    readings = ref.train_readings(cfg, SEED, train.reference_batches(pool, 4, CPU)[:1], CPU,
                                  pool=pool, given=prog)
    readings["change"] = readings["grad"]
    gaps = train.compare(prog, readings, {})
    for part in readings["parts"][0]:
        assert gaps[part]["value"] < 1e-5, (part, gaps[part])
    assert gaps["grad_diff"]["value"] < 1e-4
    if "variances" in readings:
        assert gaps["cov_var"]["value"] < 1e-4
        assert gaps["masks"]["value"] == 0.0
        own, _ = ref.masks_of(readings["variances"], cfg["model"]["clusters"])
        assert all((a == b).all() for a, b in zip(own, prog["masks"]))
