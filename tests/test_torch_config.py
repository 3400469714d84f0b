"""The port's configuration is a copy of the JAX package's, and must not
drift: every module-level constant and every dataclass, field for field,
with equal defaults (exact equality: they are ints, floats, strings and
tuples)."""

import dataclasses
import inspect

import pytest

from ptam_cg_tpu import config as jcfg
from ptam_cg_tpu_torch import config as tcfg


def _constants(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def _dataclasses(mod):
    return {k: v for k, v in vars(mod).items()
            if inspect.isclass(v) and dataclasses.is_dataclass(v)
            and v.__module__ == mod.__name__}


def test_constants_are_equal():
    ref = _constants(jcfg)
    assert "LEVELS" in ref and "MAX_CANDIDATES" in ref
    assert _constants(tcfg) == ref


def test_same_dataclasses():
    assert sorted(_dataclasses(tcfg)) == sorted(_dataclasses(jcfg))


@pytest.mark.parametrize("name", sorted(_dataclasses(jcfg)))
def test_dataclass_defaults_are_equal(name):
    ours = getattr(tcfg, name)
    ref = getattr(jcfg, name)
    fields = [(f.name, f.type) for f in dataclasses.fields(ours)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(ref)]
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen
    got = dataclasses.asdict(ours())
    assert got == dataclasses.asdict(ref())


def test_engine_config_nests_the_ports_classes():
    cfg = tcfg.default_config()
    assert isinstance(cfg.frontend, tcfg.FrontendConfig)
    assert cfg.replace(frontend=tcfg.FrontendConfig(
        fast_thresholds=(1, 2, 3, 4))).frontend.fast_thresholds == (1, 2, 3, 4)
