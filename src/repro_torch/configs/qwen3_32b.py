"""qwen3-32b [hf:Qwen/Qwen3-32B; hf] (port of ``repro/configs/qwen3_32b.py``)
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk_norm,
head_dim=128 (explicit — 64*128=8192 != d_model).
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import lm_cell, lm_shapes_for
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
)

SMOKE = LMConfig(
    name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=200, vocab=512, head_dim=16, qk_norm=True,
    param_dtype="float32", remat=False, max_seq=128,
)

ARCH = register(ArchSpec(
    name="qwen3-32b", kind="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes_for(FULL),
    build_cell=lambda cfg, shape: lm_cell(cfg, shape, "qwen3-32b"),
    notes="dense GQA with per-head qk RMSNorm",
))
