"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*; unverified] (port
of ``repro/configs/llama4_maverick_400b_a17b.py``)
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
(+1 shared expert), alternating dense/MoE layers.

Attention: iRoPE-style — 3 of every 4 layers use chunked local
attention (8192-token chunks), every 4th is global; local layers keep a
chunk-sized KV cache.
"""
from repro_torch.configs import ArchSpec, register
from repro_torch.configs.cells import lm_cell, lm_shapes_for
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1,
                  capacity_factor=1.25),
    moe_every=2,  # interleave_moe_layer_step: alternating dense/MoE
    attn_kind="chunked_local", local_chunk=8192, global_every=4,
    rope_theta=5e5,
)

SMOKE = LMConfig(
    name="llama4-maverick-smoke", n_layers=4, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=128, n_shared=1,
                  capacity_factor=2.0),
    moe_every=2,
    attn_kind="chunked_local", local_chunk=16, global_every=4,
    param_dtype="float32", remat=False, max_seq=128,
)

ARCH = register(ArchSpec(
    name="llama4-maverick-400b-a17b", kind="lm", full=FULL, smoke=SMOKE,
    shapes=lm_shapes_for(FULL),  # includes long_500k: sub-quadratic
    build_cell=lambda cfg, shape: lm_cell(
        cfg, shape, "llama4-maverick-400b-a17b"),
    notes="MoE 128e top-1 + shared; chunked-local attention (iRoPE)",
))
