"""Optimizer substrate (port of ``repro/optim``): AdamW, global-norm
clipping, the warmup-cosine schedule and int8 gradient compression over
the port's parameter trees (dicts, lists and tuples of tensors)."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.clip import (  # noqa: F401
    clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    compress_int8, decompress_int8, CompressedAllReduce)
