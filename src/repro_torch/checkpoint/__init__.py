from repro_torch.checkpoint.manager import (CheckpointCorruption,
                                            latest_step, restore_arrays,
                                            save)
