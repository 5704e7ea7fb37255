"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import FFN_NONE, SSM, SSMConfig, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,              # d_inner / ssm.head_dim = 4096 / 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    layer_plan=uniform_plan(48, SSM, FFN_NONE),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=128),
    source="arXiv:2405.21060",
)
