"""On-disk checkpoints (port of ``repro/checkpoint``): ``save_pytree`` /
``load_pytree`` and the keep-last-k ``CheckpointManager``, in the
reference's on-disk format."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.store import load_pytree, save_pytree  # noqa: F401
