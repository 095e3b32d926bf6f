"""Tree checkpointing (npz + json manifest) in the reference's format."""

from repro_torch.checkpoint.checkpoint import (latest_step, read_manifest,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest"]
