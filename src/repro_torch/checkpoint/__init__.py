from .ckpt import (AsyncCheckpointer, CheckpointWriteError, SnapshotArena,
                   available_steps, latest_step, load, restore,
                   selective_restore, save)

__all__ = ["AsyncCheckpointer", "CheckpointWriteError", "SnapshotArena",
           "available_steps", "latest_step", "load", "restore",
           "selective_restore", "save"]
