"""Registry mapping ``--arch`` ids to ModelConfig objects."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduce_for_smoke
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.yi_34b import CONFIG as _yi

ARCHS = {
    c.arch_id: c
    for c in (_deepseek, _mamba2, _musicgen, _gemma3, _gemma2, _yi, _llava,
              _qwen3, _tinyllama, _rgemma)
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    cfg = ARCHS[arch_id]
    return reduce_for_smoke(cfg) if smoke else cfg


def list_archs():
    return sorted(ARCHS)
