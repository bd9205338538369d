"""Nothing the harness or the references load has the top-level name jax,
jaxlib, flax or mrfp_tpu (compared whole: ``mrfp_tpu_torch`` is the port),
and the references load nothing of the port either."""

import subprocess
import sys

from benchmark import harness

CHECK = """
import sys
sys.path.insert(0, {root!r})
import {modules}
bad = sorted(n for n in sys.modules if n.split('.')[0] in {forbidden!r})
print(','.join(bad))
"""


def _loaded(modules, forbidden):
    code = CHECK.format(root=str(harness.ROOT), modules=", ".join(modules),
                        forbidden=tuple(forbidden))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_the_references_import_neither_jax_nor_the_port():
    refs = [f"benchmark.reference.{p.stem}" for p in (harness.HERE / "reference").glob("*.py")
            if p.stem != "__init__"]
    assert _loaded(refs, harness.FORBIDDEN + ("mrfp_tpu_torch",)) == ""


def test_a_whole_run_imports_no_jax():
    from benchmark.tests.conftest import SMALL
    code = ("import torch, time\nfrom benchmark import harness\n"
            f"m = harness.measure('mrfp_plus_r50_eval_1024x2048', 5, 0.1, True, "
            f"torch.device('cpu'), time.perf_counter(), {SMALL['eval']!r})\n"
            "harness.result(m)\n")
    out = subprocess.run([sys.executable, "-c",
                          f"import sys; sys.path.insert(0, {str(harness.ROOT)!r})\n" + code +
                          "print('forbidden=' + ','.join(harness.forbidden_modules()))"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden="


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "isw_r50_train_b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
