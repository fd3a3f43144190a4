"""``BENCHMARK.json`` against the benchmark's contract, and every cell's files
found by name: its configuration, traffic, driver, limits, the per-layer
metrics' readers and the kernels' roofline files; the entries of
``held_back.json`` held to the same rules."""

import importlib
import json
import re

import pytest

from h100bench import common, harness, instrument

BENCH = common.benchmark()
HELD = common.benchmark(held_back=True)  # held_back.json's entries held to the same rules
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert all(LINE.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(key):
    names = [e["name"] for e in HELD[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("key", ["end_to_end", "per_layer"])
def test_metric_keys_units_and_sources(key):
    for m in HELD[key]:
        base = {"name", "unit", "better", "source"} | (
            {"bound"} if key == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == base, m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        allowed = (("host_clock", "device_trace") if key == "end_to_end" else
                   ("device_trace", "program_span", "program_counter", "host_clock"))
        assert m["source"] in allowed
        assert all(w in {c["name"] for c in HELD["workloads"]} for w in m.get("workloads", []))
        assert m in BENCH[key] or m.get("workloads"), m["name"]  # held-back ones name their cell


def test_bounds_and_setup():
    e2e = {m["name"]: m for m in HELD["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())


@pytest.mark.parametrize("bench", [BENCH, HELD], ids=["benchmark", "held_back"])
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in [c["name"] for c in bench["workloads"]]:
        e2e = [m["name"] for m in harness.reported(bench, w, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w
        per_layer = harness.reported(bench, w, "per_layer")
        assert per_layer, w
        for m in per_layer:  # what a metric moves, its cells report
            assert m["moves"] in e2e, (w, m["name"])


def test_layers_are_one_line_and_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(LINE.match(layer) for layer in layers)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and LINE.match(c["why"])
        assert c["file"].startswith("h100bench/") and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        config = common.load_json(common.ROOT / c["file"])
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert config["serve"]["dtype"] == "bfloat16"


def test_workload_entries():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(WORKLOADS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(WORKLOADS) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in HELD["workloads"]])
def test_cell_files_resolve_by_name(workload):
    entry, config, traffic, limits = common.cell_files(workload, HELD)
    driver = importlib.import_module(f"h100bench.drivers.{traffic['driver']}")
    assert hasattr(driver, "Driver")
    assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())
    for m in harness.reported(HELD, workload, "per_layer"):
        assert callable(harness.load_reader(m["name"]))


def test_roofline_files_name_their_hooks_and_kinds():
    from h100bench.trace import kernel_kind

    kinds = {kernel_kind(n) for n in ("resize_kernel", "conv_bins_depth_kernel",
                                      "bins_expectation_fwd_kernel", "attn_fwd_resident_kernel",
                                      "se_project_kernel", "mbconv_kernel")}
    for mod in instrument.roofline_files():
        assert mod.KIND in kinds
        for hook in mod.HOOKS:
            assert isinstance(instrument._class(hook), type)


def test_every_metric_file_is_a_metric_of_the_benchmark():
    names = {m["name"] for m in HELD["per_layer"]}
    files = {p.stem for p in (common.BENCH_DIR / "metrics").glob("*.py")} - {"__init__"}
    assert files == names
