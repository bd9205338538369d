"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository, on a machine with the cards the cell asks
for. The last line of standard output is the result (one JSON object); the
last lines of standard error are the numbers that decide ``correct``,
each beside its limit. A traced run (``--trace 1``) also writes the
profiled sub-window's Chrome trace to ``benchmark/out/trace_<workload>.json``.
"""

import os
import sys
import time

STARTED = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache of the program and its libraries at a fixed path in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from benchmark import harness

    cell = next((w for w in harness.manifest()["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    m = harness.measure(args.workload, args.seed, args.seconds, bool(args.trace), device, STARTED)
    out = harness.result(m)
    print(f"launches in the window: {json.dumps(m.launches)}", file=sys.stderr)
    if m.gates:
        fired = [sum(g[i] for g in m.gates) for i in range(3)]
        print(f"gates fired in the window's {len(m.gates)} steps: oc {fired[0]}, np {fired[1]}, "
              f"dec {fired[2]}", file=sys.stderr)
    if m.profile is not None and m.window_s:
        print(f"tracing overhead: {m.images / m.window_s!r} images/s in the window, "
              f"{m.profiled_images / m.profile.window_s!r} in the profiled sub-window",
              file=sys.stderr)
    print(f"readings: {json.dumps(m.checks)}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: the run imported {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, check in out["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
