"""Move nested dataclasses of tensors between devices, and walk them."""

from __future__ import annotations

import dataclasses

import torch


def to_device(obj, device):
    """Copy of ``obj`` with every tensor inside (through dataclasses,
    tuples, lists and dicts) moved to ``device``. Other leaves, such as a
    ``torch.Generator``, are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def tensors(obj):
    """Every tensor inside ``obj`` (through dataclasses, tuples, lists and
    dicts), in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
