"""Architecture registry of the port: ``get_config(arch_id)``.

Only the configurations the port runs are registered; smoke variants are
``get_config(id).smoke()`` or the ``<id>-smoke`` name."""

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                      ArchConfig, ModelConfig, ShapeSpec,
                                      ShardingPlan, TrainPlan)
from repro_torch.configs.command_r_35b import CONFIG as _COMMAND_R_35B
from repro_torch.configs.gemma3_1b import CONFIG as _GEMMA3_1B
from repro_torch.configs.gemma3_27b import CONFIG as _GEMMA3_27B
from repro_torch.configs.grok_1_314b import CONFIG as _GROK_1_314B
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _H2O_DANUBE_18B
from repro_torch.configs.iterpro_100m import CONFIG as _ITERPRO_100M
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _KIMI_K2_1T_A32B
from repro_torch.configs.qwen2_vl_7b import CONFIG as _QWEN2_VL_7B
from repro_torch.configs.seamless_m4t_large_v2 import \
    CONFIG as _SEAMLESS_M4T_LARGE_V2
from repro_torch.configs.xlstm_350m import CONFIG as _XLSTM_350M
from repro_torch.configs.zamba2_7b import CONFIG as _ZAMBA2_7B

_REGISTRY = {c.arch_id: c for c in (_COMMAND_R_35B, _H2O_DANUBE_18B,
                                    _GEMMA3_1B, _GEMMA3_27B, _GROK_1_314B,
                                    _ITERPRO_100M, _KIMI_K2_1T_A32B,
                                    _QWEN2_VL_7B, _SEAMLESS_M4T_LARGE_V2,
                                    _XLSTM_350M, _ZAMBA2_7B)}


def list_archs():
    return tuple(_REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id.endswith("-smoke"):
        return _REGISTRY[arch_id[: -len("-smoke")]].smoke()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r} (have {list_archs()})")
    return _REGISTRY[arch_id]


def get_shape(name: str) -> ShapeSpec:
    return SHAPES_BY_NAME[name]


__all__ = ["ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K",
           "SHAPES_BY_NAME", "TRAIN_4K", "ArchConfig", "ModelConfig",
           "ShapeSpec", "ShardingPlan", "TrainPlan", "get_config",
           "get_shape", "list_archs"]
