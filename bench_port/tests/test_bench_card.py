"""On the card, at a cell's own size: a sound run of the program is correct
and the program's lower-precision path (the control) is not. Run with

    python3 -m pytest bench_port/tests/test_bench_card.py -m cuda -q
"""

import pytest

from bench_port import control
from bench_port.spec import Spec

SEEDS = (3_200_000_001,)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Spec().doc["workloads"]])
def test_control_fails_where_the_program_passes(cuda_device, cell):
    spec = Spec()
    limits = spec.limits(cell)
    for lower in (False, True):
        for _, out in control.readings(spec, cell, SEEDS, 5.0, lower,
                                       cuda_device):
            checks = out.checks
            ok = all(k in checks and checks[k] <= limits[k] for k in limits)
            assert ok != lower, checks
