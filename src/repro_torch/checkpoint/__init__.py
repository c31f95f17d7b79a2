from repro_torch.checkpoint.checkpoint import (load_checkpoint,  # noqa: F401
                                               restore_checkpoint,
                                               save_checkpoint)
