from repro_torch.checkpoint.io import (checkpoint_exists, load_meta,
                                       load_tree, restore_checkpoint,
                                       save_checkpoint)

__all__ = ["checkpoint_exists", "save_checkpoint", "restore_checkpoint",
           "load_meta", "load_tree"]
