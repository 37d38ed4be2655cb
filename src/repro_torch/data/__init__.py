"""Index-addressable synthetic data of the port."""

from repro_torch.data.pipeline import TokenPipeline, shard_assignment  # noqa: F401
