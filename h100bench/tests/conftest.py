"""Shared set-up of the benchmark's CPU tests: the repository on the path,
one torch thread (tiny models spin on many), and the tiny files that stand
for a cell's configuration and traffic."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import common  # noqa: E402

TINY = {"graphbins-b5": "graphbins-tiny.json", "adabins-b5": "adabins-tiny.json"}
TINY_TRAFFIC = {"batch_size": 2, "pool_requests": 4, "warmup_batches": 2, "warmup_requests": 2,
                "check_batches": 2, "pool_batches": 4, "trace_batches": 2, "trace_requests": 2,
                "trace_steps": 1}


@pytest.fixture(scope="session", autouse=True)
def one_torch_thread():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_files(workload: str):
    """The cell's workload entry and limits with the tiny configuration and
    a small traffic of the same mix, for a run on the CPU."""
    entry, config, traffic, limits = common.cell_files(workload, common.benchmark(held_back=True))
    config = common.load_json(Path(__file__).parent / "tiny" / TINY[entry["config"]])
    traffic = dict(traffic, **{k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
    return entry, config, traffic, limits


@pytest.fixture
def tiny(monkeypatch):
    """``tiny_files``, with the serving drivers' pool of frames and the
    check's blocks cut to a tiny run's size."""
    from h100bench.drivers import serving

    monkeypatch.setattr(serving, "POOL_FRAMES", 8)
    monkeypatch.setattr(serving, "REFERENCE_BLOCK", 2)
    return tiny_files
