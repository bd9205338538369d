"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <name> --seeds 12 --controls 3 \
        [--faults masks_zeroed,wt_dropped] [--witness fp32,bf16]

runs, in one process, the program on ``--seeds`` seeds (a run of the cell
with a short window: set-up, the checked steps or sweeps, the reference)
and, on ``--controls`` seeds, the control (the reference computed in the
precision just below the configuration's: FP8 conv operands for a bf16
configuration, TF32 for fp32 with TF32 off), for a training cell the fault
of half of each batch left out (the reference put in the program's
place), and each fault of ``--faults`` planted in the program
(``faults.py``). ``--witness`` reads, on the same seeds, the program in
fp32 with TF32 off (``fp32``) and the reference with its convs in
bfloat16 (``bf16``): what a training cell's gaps owe to its bf16
arithmetic. Each reading is one JSON line on standard output. A state
left unchanged reads 1 on ``change`` by definition and needs no run.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CONTROL = {"bfloat16": "fp8", "float16": "fp8", "float32": "tf32"}


def main(argv=None) -> int:
    import argparse
    import gc
    import importlib
    import json

    import torch
    from benchmark import faults, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--half-batch", type=int, choices=(0, 1), default=1,
                   help="also read the half-batch fault (training cells)")
    p.add_argument("--faults", default="", help="faults.py's faults to plant, comma-separated")
    p.add_argument("--witness", default="", help="fp32, bf16 or both, comma-separated")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    bench = harness.manifest()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dtype = cfg["train"]["compute_dtype"] if traffic["driver"] == "train" else cfg["eval"]["dtype"]
    def program(side, seed, overrides=None):
        t0 = time.perf_counter()
        m = harness.measure(args.workload, seed, 1.0, False, device, t0, overrides)
        emit(side, seed, t0, m.checks)

    def emit(side, seed, t0, checks):
        print(json.dumps({"side": side, "seed": seed, "s": time.perf_counter() - t0,
                          **{k: v["value"] for k, v in checks.items()}}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    controls = [args.first_seed + 104729 * (i + 1) for i in range(args.controls)]
    for i in range(args.seeds):
        program("program", args.first_seed + 7919 * i)
    sides = [("control", CONTROL[dtype], False)]
    if traffic["driver"] == "train" and args.half_batch:
        sides.append(("half_batch", None, True))
    witnesses = [w for w in args.witness.split(",") if w]
    if "bf16" in witnesses:
        sides.append(("witness_bf16_reference", "bf16", False))
    for side, rounding, half in sides:
        for seed in controls:
            t0 = time.perf_counter()
            emit(side, seed, t0, driver.control(cfg, traffic, seed, device, rounding, half))
    for name in [f for f in args.faults.split(",") if f]:
        for seed in controls:
            with faults.FAULTS[name]():
                program(f"fault_{name}", seed)
    if "fp32" in witnesses:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        for seed in controls:
            program("witness_fp32_program", seed, {"train.compute_dtype": "float32"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
