"""On the card (marked ``gpu``; each test skips, with its reason, where
there is no card): the comparison that decides ``correct`` against its
control at the cells' own sizes. One seed a cell, the sample cut to one
request or three steps; ``PERF.md`` has the readings over many seeds.

    python -m pytest -m gpu h100bench/tests/test_h100bench_gpu.py
"""

import pytest

from h100bench import common, control

HELD = common.benchmark(held_back=True)
CELLS = [w["name"] for w in HELD["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_program_passes_and_the_control_fails(card, workload):
    entry, config, traffic, limits = common.cell_files(workload, HELD)
    files = (entry, config, dict(traffic, check_batches=1), limits)
    program = control.readings(workload, 2147483701, 1.0, False, files=files)
    fp8 = control.readings(workload, 2147483701, 1.0, True, files=files)
    assert all(program[n] <= limit for n, limit in limits.items()), program
    assert any(fp8[n] > limit for n, limit in limits.items()), fp8
