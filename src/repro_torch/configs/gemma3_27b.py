"""gemma3-27b [dense] — 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, FFN_DENSE,
                                ModelConfig)

# Repeating pattern of 5 local (window 1024) then 1 global; 62 layers.
_plan = tuple(((ATTN_GLOBAL if (i + 1) % 6 == 0 else ATTN_LOCAL), FFN_DENSE)
              for i in range(62))

CONFIG = ModelConfig(
    arch_id="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    layer_plan=_plan,
    window=1024,
    rope_base=1000000.0,
    logit_softcap=0.0,
    use_post_norms=True,
    tie_embeddings=True,
    act="gelu",
    source="hf:google/gemma-3-1b-pt",
)
