"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 [arXiv:2412.19437].

First 3 layers are dense FFN (d_ff=18432); remaining 58 are MoE with 256
routed experts (top-8) + 1 shared expert, expert hidden 2048.  MTP (multi-
token prediction) is an auxiliary training head in the source; the backbone
here is the main model (MTP off by default; see DESIGN.md).
"""
from repro_torch.configs.base import (ATTN_MLA, FFN_DENSE, FFN_MOE, MoEConfig,
                                ModelConfig)

_plan = tuple((ATTN_MLA, FFN_DENSE if i < 3 else FFN_MOE) for i in range(61))

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: kv latent shared; head count for Q/out
    head_dim=128,            # v head dim
    d_ff=18432,              # dense layers
    vocab=129280,
    layer_plan=_plan,
    rope_base=10000.0,
    moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1),
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    source="arXiv:2412.19437",
)
