"""The port's serving path on the CPU: the eval forward exported by
``torch.export`` with the bilinear resize as the registered op
``mrfp::resize_bilinear`` (``ops/library.py``), saved and loaded through
``mrfp_tpu_torch.serving``, and ``cli.export``.

R50-D16 at 1x64x64; the weights are the JAX model's seeded init, converted
with ``weights.state_dict_from_jax``, so the artifact is also held against
the JAX eval forward (atol 5e-4, the eval parity bound of
tests/test_torch_model.py). Every artifact (~160 MB) lives in a temporary
directory removed when the module is done.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu_torch import serving
from mrfp_tpu_torch.cli import export as cli_export
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.ops import resize as port_resize
from mrfp_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
HW = (64, 64)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMRFP(trunk="resnet-50", variant="D16")
    variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, *HW, 3)), train=False)
    port = MRFP(trunk="resnet-50", variant="D16")
    port.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                         strict=True)
    return jmodel, variables, port.eval()


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """``get(dtype, wire) -> (path, ServingForward, ExportedProgram)``,
    exported once each; the directory goes with the module."""
    root = tmp_path_factory.mktemp("artifacts")
    made = {}

    def get(dtype="float32", wire="uint8"):
        if (dtype, wire) not in made:
            fwd = cli_export.ServingForward(models[2], autocast=dtype == "bfloat16")
            example = torch.zeros((1, *HW, 3), dtype=getattr(torch, wire))
            program = cli_export.export_program(fwd, example)
            path = str(root / f"m_{dtype}_{wire}.pt2x")
            serving.save_exported(path, program, {
                "device_type": "cpu", "device": "cpu", "compute_dtype": dtype,
                "input": {"shape": [1, *HW, 3], "dtype": wire}})
            made[dtype, wire] = (path, fwd, program)
        return made[dtype, wire]

    yield get
    for path, _, _ in made.values():
        os.unlink(path)


def _images(wire="uint8", seed=1):
    x = np.random.default_rng(seed).integers(0, 256, (1, *HW, 3)).astype(np.uint8)
    return torch.from_numpy(x if wire == "uint8" else x.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_round_trip_is_bit_exact(artifacts, dtype):
    path, fwd, _ = artifacts(dtype)
    fn, manifest = serving.load_exported(path)
    x = _images()
    got = fn(x)
    with torch.no_grad():
        want = fwd(x)
    assert manifest["compute_dtype"] == dtype
    assert got.dtype == torch.float32 and got.shape == (1, 19, *HW)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,tf32_inside", [("float32", {False}), ("bfloat16", {True})])
def test_float32_artifacts_run_without_tf32(artifacts, monkeypatch, dtype, tf32_inside):
    """A float32 artifact runs its ops with TF32 off whatever the process
    says (a fresh process defaults cuDNN to TF32), and puts the switches
    back; a bf16 one leaves them alone."""
    from torch.utils._python_dispatch import TorchDispatchMode
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    fn, _ = serving.load_exported(artifacts(dtype)[0])
    seen = set()

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                seen.add(torch.backends.cudnn.allow_tf32)
            return func(*args, **(kwargs or {}))

    with Watch():
        fn(_images())
    assert seen == tf32_inside
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_uint8_wire_equals_float32_wire(artifacts):
    fn8, _ = serving.load_exported(artifacts("float32", "uint8")[0])
    fn32, _ = serving.load_exported(artifacts("float32", "float32")[0])
    x = _images()
    assert torch.equal(fn8(x), fn32(x.float()))


def test_artifact_matches_the_jax_eval_forward(models, artifacts):
    jmodel, variables, _ = models
    fn, _ = serving.load_exported(artifacts("float32")[0])
    x = _images(seed=2)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x.numpy(), jnp.float32),
                                  train=False, mutable=False)["logits"])
    got = np.transpose(fn(x).numpy(), (0, 2, 3, 1))
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_holds_three_registered_resizes(artifacts, dtype):
    """The ASPP image-pool broadcast, the decoder upsample and the logits:
    three op nodes (inside the autocast region for bf16), and no gather of
    a plain resize."""
    program = artifacts(dtype)[2]
    names = [serving.op_name(n) for n in serving.graph_nodes(program)]
    assert names.count("mrfp::resize_bilinear") == 3
    assert not [n for n in names if n.startswith("aten::index")], names
    assert serving.registered_ops(program) == ["mrfp::resize_bilinear"]


def test_export_first_then_live_forward_is_real(models, monkeypatch):
    """The cache-poisoning regression: with no table cached yet, an export
    traces the model first; the live forward after it must still return
    real logits, equal to a forward that never saw an export."""
    port = models[2]
    x = _images(seed=3).permute(0, 3, 1, 2).float().contiguous()
    with torch.no_grad():
        want = port(x)
    monkeypatch.setattr(port_resize, "_TAPS", {})
    fwd = cli_export.ServingForward(port, autocast=False)
    cli_export.export_program(fwd, torch.zeros((1, *HW, 3), dtype=torch.uint8))
    assert port_resize._TAPS == {}  # the trace built no table
    with torch.no_grad():
        got = port(x)
    assert type(got) is torch.Tensor
    assert torch.equal(got, want)
    assert all(type(t) is torch.Tensor for taps in port_resize._TAPS.values() for t in taps)


def test_tables_are_never_built_under_a_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        for build in (lambda: port_resize.bilinear_taps(7, 29, "cpu"),
                      lambda: port_resize.nearest_table(7, "size", 29, "cpu"),
                      lambda: port_resize.onehot_table((0, 3, 5), 7, "cpu")):
            with pytest.raises(RuntimeError, match="while tracing"):
                build()


def test_bad_magic_and_jax_artifacts_are_refused(tmp_path):
    bad = tmp_path / "bad.pt2x"
    bad.write_bytes(b"NOTMAGIC" + b"\0" * 16)
    with pytest.raises(ValueError, match="not an mrfp_tpu_torch artifact"):
        serving.load_exported(str(bad))
    jax_file = tmp_path / "model.mrfpx"
    meta = b'{"format": "mrfpx-v1"}'
    jax_file.write_bytes(b"MRFPXPT1" + struct.pack("<I", len(meta)) + meta + b"blob")
    with pytest.raises(ValueError, match="JAX .mrfpx artifact"):
        serving.load_exported(str(jax_file))


def _header_only(path, device_type):
    meta = ('{"device_type": "%s", "device": "NVIDIA H100 80GB HBM3"}' % device_type).encode()
    path.write_bytes(serving.MAGIC + struct.pack("<I", len(meta)) + meta)
    return str(path)


def test_device_of_the_artifact_is_enforced(tmp_path, monkeypatch):
    """A CUDA artifact never loads on the CPU, and none loads for another
    device type than its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serving.load_exported(_header_only(tmp_path / "c.pt2x", "cuda"))
    with pytest.raises(ValueError, match="--device cuda"):
        serving.load_exported(_header_only(tmp_path / "p.pt2x", "cpu"), device="cuda")


def test_cli_export_checks_and_writes_the_manifest(tmp_path):
    out = str(tmp_path / "m.pt2x")
    result = cli_export.main(["--device", "cpu", "--height", "48", "--width", "64",
                              "--dtype", "float32", "--check", "--out", out])
    try:
        assert "bit for bit" in result["check"]
        manifest = serving.read_manifest(out)[0]
        assert manifest["format"] == "mrfp-torch-export-v1"
        assert manifest["input"] == {"shape": [1, 48, 64, 3], "dtype": "uint8",
                                     "layout": "NHWC", "pixel_scale": "raw 0..255"}
        assert manifest["output"]["shape"] == [1, 19, 48, 64]
        assert manifest["ops"] == ["mrfp::resize_bilinear"]
        assert (manifest["device_type"], manifest["device"]) == ("cpu", "cpu")
        assert manifest["torch"] == torch.__version__ and manifest["ckpt"] == "random-init"
    finally:
        os.unlink(out)


@pytest.mark.parametrize("flags", [["--arch", "DeepMobileNetV3PlusD"], ["--wt-layer", *"0004500"],
                                   ["--trunk", "shufflenetv2", "--wt-layer", *"0000000"]])
def test_cli_export_refuses_the_zoo(tmp_path, flags):
    """The zoo's other trunks and iw code 5 export too: each ``--check``
    holds the artifact to the live forward bit for bit (the three flag
    sets were refused before those modules were ported)."""
    out = str(tmp_path / "m.pt2x")
    res = cli_export.main(["--device", "cpu", "--out", out, "--height", "48", "--width", "64",
                           "--dtype", "float32", "--check", *flags])
    try:
        assert "bit for bit" in res["check"]
        assert res["manifest"]["output"]["shape"] == [1, 19, 48, 64]
        assert res["manifest"]["model"]["zoo"] == (flags[1] if flags[0] == "--arch"
                                                   else "DeepV3Plus")
    finally:
        os.unlink(out)


def test_cli_export_cuda_without_cuda_exits_nonzero(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli_export.main(["--device", "cuda", "--out", str(tmp_path / "m.pt2x")])
    assert exc.value.code not in (0, None)


def test_loading_needs_no_model_code(artifacts):
    """A fresh process loads and runs the artifact through ``serving``
    alone: the op registration comes in, no module of models, nn, perturb
    or train does."""
    path = artifacts("float32")[0]
    code = ("import sys, torch\n"
            "from mrfp_tpu_torch.serving import load_exported\n"
            f"fn, mf = load_exported({path!r})\n"
            "y = fn(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))\n"
            "assert y.shape == (1, 19, 64, 64), y.shape\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[:2] in ("
            "['mrfp_tpu_torch', 'models'], ['mrfp_tpu_torch', 'nn'], "
            "['mrfp_tpu_torch', 'perturb'], ['mrfp_tpu_torch', 'train']))\n"
            "assert not bad, bad\n"
            "assert 'mrfp_tpu_torch.ops.library' in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
