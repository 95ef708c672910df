from .checkpoint import (CheckpointManager, latest_step, load_trainer_state,
                         restore_checkpoint, save_checkpoint, sweep_tmp,
                         trainer_state)

__all__ = ["CheckpointManager", "latest_step", "load_trainer_state",
           "restore_checkpoint", "save_checkpoint", "sweep_tmp",
           "trainer_state"]
