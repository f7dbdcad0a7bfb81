"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified] (port
of ``repro/configs/command_r_35b.py``)
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, dense, no-bias.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import lm_cell, lm_shapes_for
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="command-r-35b", n_layers=40, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22528, vocab=256000, rope_theta=8e6,
)

SMOKE = LMConfig(
    name="command-r-35b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=176, vocab=512, param_dtype="float32",
    remat=False, max_seq=128,
)

ARCH = register(ArchSpec(
    name="command-r-35b", kind="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes_for(FULL),
    build_cell=lambda cfg, shape: lm_cell(cfg, shape, "command-r-35b"),
    notes="dense GQA, no-bias",
))
