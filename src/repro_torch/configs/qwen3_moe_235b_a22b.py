"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import (ATTN_GLOBAL, FFN_MOE, MoEConfig, ModelConfig,
                                uniform_plan)

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # unused by MoE layers (all layers MoE)
    vocab=151936,
    layer_plan=uniform_plan(94, ATTN_GLOBAL, FFN_MOE),
    rope_base=1000000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536, n_shared=0),
    source="hf:Qwen/Qwen3-30B-A3B",
)
