"""Copy of ``repro.configs.registry``: the ten architectures, ``get_arch``
and ``smoke``, and the transport, comm-mode and stencil tables."""

from __future__ import annotations

from .base import SHAPES, ModelConfig

#: valid ``comm_mode`` strings of the launchers: ``smi:<backend>`` picks the
#: transport backend that moves the bytes; bare ``"smi"`` means
#: ``smi:static``; ``"smi:compressed"`` runs the int8 wire over the static
#: schedules (``compressed:<inner>`` composes with any backend); ``"bulk"``
#: moves a collective in one untallied pass
TRANSPORT_BACKENDS: tuple[str, ...] = ("static", "packet", "fused", "compressed")
COMM_MODES: tuple[str, ...] = ("smi", *(f"smi:{b}" for b in TRANSPORT_BACKENDS), "bulk")

#: default (grid, domain, steps) cells the stencil launcher runs: the
#: paper's 8-rank testbed shape as a torus and as a 1D ring
STENCIL_CASES: dict[str, dict] = {
    "ring8": {"grid": (1, 8), "domain": (256, 256), "steps": 8},
    "torus2x4": {"grid": (2, 4), "domain": (256, 256), "steps": 8},
    "torus2x2": {"grid": (2, 2), "domain": (256, 256), "steps": 8},
}

GLM4_9B = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=151_552,
    head_dim=128, qkv_bias=True, rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b; hf",
)

YI_6B = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64_000,
    head_dim=128, rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
)

MINITRON_4B = ModelConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=9216, vocab_size=256_000,
    head_dim=128, mlp_type="gelu",  # nemotron squared-relu family; gelu proxy
    source="arXiv:2407.14679; hf",
)

COMMAND_R_PLUS_104B = ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab_size=256_000,
    head_dim=128, rope_theta=75_000_000.0, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

MAMBA2_2P7B = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50_280,
    pattern=("ssm",), ssm_state=128, ssm_expand=2, ssm_headdim=64,
    source="arXiv:2405.21060; unverified",
)

RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256_000,
    head_dim=256, pattern=("rec", "rec", "attn"), local_window=2048,
    lru_width=4096,
    source="arXiv:2402.19427; unverified",
)

QWEN3_MOE_30B_A3B = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab_size=151_936,
    head_dim=128, pattern=("moe",), n_experts=128, top_k=8,
    d_ff_expert=768, qk_norm=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

LLAMA4_SCOUT_17B_A16E = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202_048,
    head_dim=128, pattern=("moe",), n_experts=16, top_k=1,
    d_ff_expert=8192, shared_expert=True, rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

INTERNVL2_1B = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151_655,
    head_dim=64, qkv_bias=True, rope_theta=1_000_000.0,
    frontend="vit_stub", n_patches=256, tie_embeddings=True,
    source="arXiv:2404.16821; hf",
)

MUSICGEN_MEDIUM = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
    head_dim=64, mlp_type="gelu", n_codebooks=4,
    frontend="encodec_stub",
    source="arXiv:2306.05284; hf",
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        GLM4_9B, YI_6B, MINITRON_4B, COMMAND_R_PLUS_104B, MAMBA2_2P7B,
        RECURRENTGEMMA_9B, QWEN3_MOE_30B_A3B, LLAMA4_SCOUT_17B_A16E,
        INTERNVL2_1B, MUSICGEN_MEDIUM,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, len(cfg.pattern)),
        d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.family == "moe":
        # capacity 4.0: no token drops at init => dispatch order-independent
        # (exact single-device vs TP comparisons in tests)
        kw.update(n_experts=4, top_k=min(2, cfg.top_k or 1), d_ff_expert=64,
                  capacity_factor=4.0)
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_headdim=16, ssm_expand=2,
                  n_heads=1, n_kv_heads=1)
    if cfg.family == "hybrid":
        kw.update(n_layers=3, lru_width=64, local_window=16,
                  n_heads=4, n_kv_heads=1)
    if cfg.family == "vlm":
        kw.update(n_patches=8)
    if cfg.family == "audio":
        kw.update(vocab_size=256)
    return cfg.scaled(**kw)


def cells():
    """Every (arch, shape, skip) dry-run cell (the reference's ``cells``):
    ``skip`` names why a cell is not run, or is None."""
    out = []
    for name, cfg in ARCHS.items():
        for sname in SHAPES:
            skip = None
            if sname == "long_500k" and not cfg.sub_quadratic:
                skip = "pure full-attention arch: 512k dense KV excluded (DESIGN.md §4)"
            out.append((name, sname, skip))
    return out
