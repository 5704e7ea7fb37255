"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385]."""
from repro_torch.configs.base import ATTN_GLOBAL, FFN_DENSE, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    arch_id="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    layer_plan=uniform_plan(22, ATTN_GLOBAL, FFN_DENSE),
    rope_base=10000.0,
    source="arXiv:2401.02385",
)
