"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ATTN_GLOBAL, FFN_DENSE, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    layer_plan=uniform_plan(60, ATTN_GLOBAL, FFN_DENSE),
    rope_base=5000000.0,
    source="arXiv:2403.04652",
)
