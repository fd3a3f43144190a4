"""One run of one cell: set-up, the measured window, the traced window in a
``--trace 1`` run, the program freed, the check against the reference, and
the run's result line.

``setup_s`` runs from the process's start (``run.py`` takes the clock
before any import) to the window's first request or step: the model built
from the seed's weights, the kernel library built or loaded, every shape of
the cell's mix warmed up. ``memory_peak_bytes`` is read once the window and
the traced window are over, before the reference runs.
"""

from __future__ import annotations

import importlib
import time

from h100bench import common


def reported(bench: dict, workload: str, key: str) -> list[dict]:
    """The metrics of ``bench[key]`` that the cell reports: those that list
    it under ``workloads``, or list none."""
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    import importlib.util

    path = common.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(device: str, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, files=None) -> dict:
    """-> the run's result (the contract's keys, ``checks`` last). ``files``
    stands for ``common.cell_files(workload)`` where a test gives its own."""
    t_start = time.perf_counter() if t_start is None else t_start
    entry, config, traffic, limits = files or common.cell_files(workload, bench)
    cell = common.Cell(workload, config, traffic, limits, seed, device)
    driver = importlib.import_module(f"h100bench.drivers.{traffic['driver']}").Driver(cell)
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    end_to_end, window = driver.window(seconds)
    readings = {"window": window}
    result = {"correct": False, "attempted": driver.attempted, "failed": driver.failed}
    if trace:
        readings.update(driver.traced())
        readings["flops_per_image"] = driver.flops_per_image()
        metrics = {}
        for m in reported(bench, workload, "per_layer"):
            value = load_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in reported(bench, workload, "end_to_end")}
    info = device_info(device, entry["chips"])
    if trace:
        from h100bench.trace import breakdown

        info.update(busy_s=readings["trace"]["busy_s"], window_s=readings["trace"]["window_s"])
        result["breakdown"] = breakdown(readings["trace"])
    driver.free_program()
    values = driver.checks()
    ok, report = common.check_report({n: (values[n], limits[n]) for n in limits})
    result.update(correct=ok, metrics=metrics, device=info, checks=report)
    # breakdown before checks: ``checks`` is the line's last key
    return {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device",
                                   *(("breakdown",) if trace else ()), "checks")}
