"""Optimizers and learning-rate schedules of the port (AdamW with f32
moments; Adafactor and the bf16/int8 moments are not ported yet)."""

from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          clip_by_global_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
