"""Architecture config system.

Every assigned architecture gets a ``ModelConfig`` here; reduced variants
(for CPU smoke tests) are derived with ``reduce_for_smoke``.  A config fully
determines the parameter pytree and the forward graph — there is no other
source of truth.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# Layer mixer kinds.
ATTN_GLOBAL = "attn_global"    # full causal attention
ATTN_LOCAL = "attn_local"      # sliding-window causal attention
ATTN_MLA = "attn_mla"          # DeepSeek multi-head latent attention
SSM = "ssm"                    # Mamba-2 SSD mixer
RGLRU = "rglru"                # RecurrentGemma RG-LRU mixer

# FFN kinds.
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"              # mamba2 blocks have no separate FFN


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                   # per-expert hidden dim
    n_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128             # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0           # 0 => d_model
    conv_width: int = 4
    block_width_factor: int = 3  # d_ff multiplier handled by cfg.d_ff


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # Per-layer plan: tuple of (mixer_kind, ffn_kind) of length n_layers.
    layer_plan: Tuple[Tuple[str, str], ...]
    rope_base: float = 10000.0
    window: int = 0              # sliding window for ATTN_LOCAL layers
    attn_softcap: float = 0.0    # gemma2-style logit soft-capping inside attn
    logit_softcap: float = 0.0   # final-logit softcap
    norm_eps: float = 1e-6
    use_post_norms: bool = False  # gemma2/3 post-attn/post-ffn norms
    tie_embeddings: bool = False
    act: str = "silu"            # silu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # MLA (DeepSeek) dims; active when any layer uses ATTN_MLA.
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # Modality frontends (stubbed per DESIGN.md §4).
    n_codebooks: int = 0         # audio: EnCodec codebooks
    n_img_tokens: int = 0        # vlm: projected patch embeddings per sample
    # Source citation.
    source: str = ""

    @property
    def qk_head_dim(self) -> int:
        if self.is_mla:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def is_mla(self) -> bool:
        return any(m == ATTN_MLA for m, _ in self.layer_plan)

    @property
    def supports_long_context(self) -> bool:
        """True if every attention layer is windowed OR attention-free, or the
        full-attention layers are a bounded minority with shardable caches
        (gemma local:global patterns) — see DESIGN.md long_500k policy."""
        kinds = {m for m, _ in self.layer_plan}
        if kinds <= {SSM, RGLRU, ATTN_LOCAL}:
            return True
        # gemma-style mixed local/global: allowed (bounded global cache).
        if ATTN_LOCAL in kinds and ATTN_GLOBAL in kinds:
            return True
        return False

    def layer_groups(self) -> Sequence[Tuple[Tuple[Tuple[str, str], ...], int]]:
        """Partition layer_plan into maximal repeating groups for
        scan-over-layers: returns [(block_plan, repeat), ...] where
        block_plan is a short tuple of (mixer, ffn) and repeat is the scan
        length.  Greedy: finds the smallest period covering a prefix run."""
        plan = list(self.layer_plan)
        groups = []
        i = 0
        while i < len(plan):
            best = (1, 1)  # (period, reps)
            for period in (1, 2, 3, 4, 6):
                if i + period > len(plan):
                    break
                pat = plan[i:i + period]
                reps = 1
                while plan[i + reps * period: i + (reps + 1) * period] == pat:
                    reps += 1
                # Only multi-rep patterns justify a longer period (a period-p
                # group with reps=1 is p distinct compiled blocks — never
                # better than p period-1 groups).
                if (reps > 1 or period == 1) and reps * period > best[0] * best[1]:
                    best = (period, reps)
            period, reps = best
            groups.append((tuple(plan[i:i + period]), reps))
            i += period * reps
        return groups


def uniform_plan(n_layers: int, mixer: str, ffn: str = FFN_DENSE):
    return tuple((mixer, ffn) for _ in range(n_layers))


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: ≤2 super-blocks, d_model ≤ 512, ≤4 experts."""
    groups = cfg.layer_groups()
    period = max(len(g[0]) for g in groups)
    # keep one period of the dominant pattern (covers every layer kind).
    plan = []
    seen = set()
    for block, _ in groups:
        key = tuple(block)
        if key not in seen:
            seen.add(key)
            plan.extend(block)
    plan = tuple(plan[:4]) if len(plan) > 4 else tuple(plan)
    d_model = 128
    n_heads = 4
    n_kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else n_heads
    head_dim = 32
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, n_experts=4, top_k=2, d_ff=64,
                                  n_shared=min(cfg.moe.n_shared, 1))
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=8)
    rglru = cfg.rglru
    kwargs = dict(
        arch_id=cfg.arch_id + "-smoke",
        n_layers=len(plan), layer_plan=plan,
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
        d_ff=256, vocab=512, window=min(cfg.window, 16) if cfg.window else 0,
        moe=moe, ssm=ssm, rglru=rglru,
        n_codebooks=cfg.n_codebooks, n_img_tokens=8 if cfg.n_img_tokens else 0,
    )
    if cfg.is_mla:
        kwargs.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=16, v_head_dim=32)
    return dataclasses.replace(cfg, **kwargs)


# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
