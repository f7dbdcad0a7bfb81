"""deepseek-moe-16b [arXiv:2401.06066; hf] (port of
``repro/configs/deepseek_moe_16b.py``)
28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed top-6 (fine-grained experts, d_ff_expert=1408).

As in the reference, all 28 layers are MoE (the HF checkpoint keeps
layer 0 dense), which changes <0.5% of FLOPs.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import lm_cell, lm_shapes_for
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25),
    rope_theta=1e4,
)

SMOKE = LMConfig(
    name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=44, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=44, n_shared=2,
                  capacity_factor=2.0),
    param_dtype="float32", remat=False, max_seq=128,
)

ARCH = register(ArchSpec(
    name="deepseek-moe-16b", kind="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes_for(FULL),
    build_cell=lambda cfg, shape: lm_cell(cfg, shape, "deepseek-moe-16b"),
    notes="fine-grained MoE 64e top-6 + 2 shared; MHA (kv=16)",
))
