from repro_torch.checkpointing.manager import CheckpointManager  # noqa: F401
