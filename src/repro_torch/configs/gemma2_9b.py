"""gemma2-9b [dense] — local+global alternating, logit softcap [arXiv:2408.00118]."""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, FFN_DENSE,
                                ModelConfig)

# Alternating local (window 4096) / global, starting with local.
_plan = tuple(((ATTN_LOCAL if i % 2 == 0 else ATTN_GLOBAL), FFN_DENSE)
              for i in range(42))

CONFIG = ModelConfig(
    arch_id="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    layer_plan=_plan,
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    use_post_norms=True,
    tie_embeddings=True,
    act="gelu",
    source="arXiv:2408.00118",
)
