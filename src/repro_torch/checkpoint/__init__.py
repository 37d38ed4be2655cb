"""Disk checkpointing of the port (the classic C/R baseline)."""

from repro_torch.checkpoint.store import (CheckpointManager,  # noqa: F401
                                          load_checkpoint, save_checkpoint,
                                          tree_digests)
