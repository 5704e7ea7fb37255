"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec is a STUB per the assignment: input_specs() provides
4-codebook token ids ``[B, S, 4]`` (delay-pattern interleaved); the decoder
sums the 4 codebook embeddings per frame and predicts 4 parallel heads.
"""
from repro_torch.configs.base import ATTN_GLOBAL, FFN_DENSE, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    layer_plan=uniform_plan(48, ATTN_GLOBAL, FFN_DENSE),
    act="gelu",
    n_codebooks=4,
    source="arXiv:2306.05284",
)
