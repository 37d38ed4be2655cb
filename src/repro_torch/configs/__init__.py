"""Architecture registry of the port: ``get_config(arch_id)``.

Only the configurations the port runs are registered; smoke variants are
``get_config(id).smoke()`` or the ``<id>-smoke`` name."""

from repro_torch.configs.base import (ArchConfig, ModelConfig, ShardingPlan,
                                      TrainPlan)
from repro_torch.configs.iterpro_100m import CONFIG as _ITERPRO_100M

_REGISTRY = {c.arch_id: c for c in (_ITERPRO_100M,)}


def list_archs():
    return tuple(_REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id.endswith("-smoke"):
        return _REGISTRY[arch_id[: -len("-smoke")]].smoke()
    if arch_id not in _REGISTRY:
        raise KeyError(f"{arch_id!r} is not ported (have {list_archs()})")
    return _REGISTRY[arch_id]


__all__ = ["ArchConfig", "ModelConfig", "ShardingPlan", "TrainPlan",
           "get_config", "list_archs"]
