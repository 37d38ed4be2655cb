"""Optimizers and learning-rate schedules of the port: AdamW with f32,
bf16 or int8 moments, and Adafactor."""

from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          clip_by_global_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
