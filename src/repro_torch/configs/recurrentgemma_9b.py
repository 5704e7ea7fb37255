"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 [arXiv:2402.19427].

Griffin pattern: (recurrent, recurrent, local-attention) repeated; 38 layers
= 12 full periods + 2 trailing recurrent blocks.  MQA (kv=1), window 2048.
"""
from repro_torch.configs.base import (ATTN_LOCAL, FFN_DENSE, RGLRU, RGLRUConfig,
                                ModelConfig)

_plan = []
for i in range(38):
    _plan.append((ATTN_LOCAL if i % 3 == 2 else RGLRU, FFN_DENSE))
_plan = tuple(_plan)

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_plan=_plan,
    window=2048,
    act="gelu",
    use_post_norms=False,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    source="arXiv:2402.19427",
)
