from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step, load_checkpoint, save_checkpoint,
)
