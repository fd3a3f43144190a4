"""Run one cell of the benchmark once, on this machine's cards.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's result as the last line of
standard output (one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit) and the checks again as
the last lines of standard error. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics. Exits non-zero,
with no result, where there is no CUDA card or fewer than the cell asks
for, and where the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import common, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    common.set_environment()
    bench = common.benchmark()
    entry = common.cell_files(args.workload, bench)[0]
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); found {cards}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = common.forbidden_modules()
    if found:
        print("the process loaded JAX or the JAX package: " + ", ".join(found), file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    common.print_checks(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
