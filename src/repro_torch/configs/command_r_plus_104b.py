"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-plus; unverified]
(port of ``repro/configs/command_r_plus_104b.py``)
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, dense, no-bias.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import lm_cell, lm_shapes_for
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab=256000, rope_theta=8e6,
)

SMOKE = LMConfig(
    name="command-r-plus-104b-smoke", n_layers=2, d_model=96, n_heads=8,
    n_kv_heads=2, d_ff=264, vocab=512, param_dtype="float32",
    remat=False, max_seq=128,
)

ARCH = register(ArchSpec(
    name="command-r-plus-104b", kind="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes_for(FULL),
    build_cell=lambda cfg, shape: lm_cell(
        cfg, shape, "command-r-plus-104b"),
    notes="dense GQA, no-bias; the largest dense cell (104B params)",
))
