"""Every traffic mix is read and checked by the one reader."""

import pytest

from bench_port import traffic
from bench_port.spec import Spec


def test_every_mix_of_the_benchmark_reads():
    s = Spec()
    for w in s.doc["workloads"]:
        assert traffic.read(s.traffic(w["traffic"]))["loop"] in traffic.LOOPS


@pytest.mark.parametrize("mix", [{"loop": "sideways"}, {},
                                 {"loop": "closed", "rate_hz": 30}])
def test_a_mix_the_reader_cannot_run_is_refused(mix):
    with pytest.raises(ValueError):
        traffic.read(mix)
