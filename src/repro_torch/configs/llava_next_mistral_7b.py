"""llava-next-mistral-7b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone = Mistral-7B. Vision frontend (SigLIP/CLIP ViT + projector) is a
STUB per the assignment: input_specs() provides projected patch embeddings
``[B, n_img_tokens, d_model]`` that the decoder interleaves before the text.
"""
from repro_torch.configs.base import ATTN_GLOBAL, FFN_DENSE, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    layer_plan=uniform_plan(32, ATTN_GLOBAL, FFN_DENSE),
    rope_base=1000000.0,
    n_img_tokens=2304,   # anyres 2x2 grid + base: ~5 x 576 capped to seq budget
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
