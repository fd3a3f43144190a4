"""The readings a correctness limit is set from, on the card, at the cell's
own size: the program's over many seeds (a short window each, then the
run's own check), or the control's, the plain reference computed in fp8
standing in for the program (``reference/precision.py``) on the same
inputs. All seeds run in one process, one after another.

    python3 h100bench/control.py --workload <name> --seeds 1,2,3 [--seconds 2]
        [--control | --half-batch | --fp32-compute]

Prints one JSON line a seed: {"seed", "mode", "checks": {name: value}}.
The benchmark's own runs never run the control.
"""

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import common  # noqa: E402


def readings(workload: str, seed: int, seconds: float, control: bool, device: str = "cuda",
             files=None, fault=None) -> dict:
    """The check's numbers (all that the driver gives, the compared ones and
    the others) for one seed; ``fault``, where given, is called with the
    driver after the window and may break its state first."""
    entry, config, traffic, limits = files or common.cell_files(
        workload, common.benchmark(held_back=True))
    cell = common.Cell(workload, config, traffic, limits, seed, device)
    driver = importlib.import_module(f"h100bench.drivers.{traffic['driver']}").Driver(cell)
    driver.window(seconds)
    if fault is not None:
        fault(driver)
    driver.free_program()
    values = driver.checks(control=control)
    del driver
    gc.collect()
    return values


def half_batch(driver) -> None:
    """The half-batch fault, planted in the reference put in the program's
    place: the program's readings become the reference's over the first
    half of each checked batch, the loss's mean over those rows."""
    driver.free_program()
    b = driver.batch // 2
    full = driver.batches, driver.objects
    driver.batches = [{k: v[:b] for k, v in x.items()} for x in full[0]]
    driver.objects = [None if o is None else {k: v[:b] for k, v in o.items()} for o in full[1]]
    driver.losses, driver.grads, driver.change = driver.reference_steps(control=False)
    driver.batches, driver.objects = full


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--half-batch", action="store_true",
                   help="train cells: the reference over half of each batch stands for the "
                        "program (a fault the check has to catch)")
    p.add_argument("--fp32-compute", action="store_true",
                   help="train cells: the program with fp32 compute, a second witness of what "
                        "bf16 compute rounds")
    args = p.parse_args(argv)
    common.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    mode = ("control" if args.control else "half-batch" if args.half_batch
            else "fp32-compute" if args.fp32_compute else "program")
    files = common.cell_files(args.workload, common.benchmark(held_back=True))
    if args.fp32_compute:
        entry, config, traffic, limits = files
        files = entry, dict(config, train=dict(config["train"], compute_dtype="float32")), \
            traffic, limits
    for seed in (int(s) for s in args.seeds.split(",")):
        values = readings(args.workload, seed, args.seconds, args.control, files=files,
                          fault=half_batch if args.half_batch else None)
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "mode": mode, "checks": values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
