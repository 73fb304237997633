"""Architecture configuration schema + input shapes: the port's own copy of
``repro.configs.base``.

Every architecture is an instance of :class:`ModelConfig`; the four input
shapes are :data:`SHAPES`.  The derived fields (``hd``, ``padded_vocab``,
``layer_pattern``, ``param_count``) equal the reference's, which the tests
hold for every architecture.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # block pattern, one entry per layer within a period
    pattern: tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"       # swiglu | gelu
    # attention details
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    local_window: int | None = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    # modality frontends (stubs per assignment)
    n_codebooks: int = 1           # musicgen: EnCodec streams
    frontend: str | None = None    # vit_stub | encodec_stub
    n_patches: int = 0             # vlm: image tokens prepended
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # comm: default tuning plan for the model's layer channels.  "auto"
    # (the default for every arch) hands backend/wire/chunk selection per
    # tag to the netsim tuner whenever the launch comm_mode doesn't pin a
    # backend (bare "smi"); an explicit "smi:<backend>" comm_mode — or
    # cfg.scaled(comm_plan=None) — is the escape hatch that pins it.
    comm_plan: str | None = "auto"
    source: str = ""               # provenance tag from the assignment

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no unbounded full-attention layer.
        NOTE: "moe" blocks contain attention too."""
        attn_kinds = {"attn", "moe"} & set(self.pattern)
        if not attn_kinds:
            return True  # pure ssm/rec
        # hybrids qualify if every attention layer has a bounded window
        return self.local_window is not None

    @property
    def layer_pattern(self) -> tuple[str, ...]:
        """Full per-layer kinds, pattern tiled to n_layers."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced-config variant (smoke tests)."""
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        D, V = self.d_model, self.padded_vocab
        hd = self.hd
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D * (0 if self.n_codebooks > 1 else 1)
        if self.n_codebooks > 1:
            n += self.n_codebooks * V * D      # codebook embeds
            n += self.n_codebooks * V * D      # codebook heads
        for kind in self.layer_pattern:
            if kind in ("attn", "moe"):
                qkv = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd)
                o = (self.n_heads * hd) * D
                n += qkv + o
                if self.qkv_bias:
                    n += (self.n_heads + 2 * self.n_kv_heads) * hd
            if kind == "attn":
                if self.mlp_type == "swiglu":
                    n += 3 * D * self.d_ff
                else:
                    n += 2 * D * self.d_ff
            elif kind == "moe":
                n += D * self.n_experts  # router
                n += self.n_experts * 3 * D * self.d_ff_expert
                if self.shared_expert:
                    n += 3 * D * self.d_ff
            elif kind == "ssm":
                d_in = self.ssm_expand * D
                nh = d_in // self.ssm_headdim
                g = self.ssm_state
                # in_proj: z, x, B, C, dt ; out_proj
                n += D * (2 * d_in + 2 * g + nh) + d_in * D
                n += self.ssm_conv * (d_in + 2 * g)  # conv
                n += 2 * nh  # A, D per head
            elif kind == "rec":
                w = self.lru_width or D
                n += D * w * 2       # in proj (branch + gate)
                n += self.ssm_conv * w
                n += 3 * w           # lru gates (a, input gate) diag params
                n += 2 * w * D // 1  # rg-lru input/rec gates (low-rank-ish, approx)
                n += w * D           # out proj
                if self.mlp_type == "swiglu":
                    n += 3 * D * self.d_ff
                else:
                    n += 2 * D * self.d_ff
            n += 2 * D  # norms
        n += D  # final norm
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts top_k + shared experts."""
        if self.n_experts == 0:
            return self.param_count()
        dense_like = self.param_count()
        dense_like -= self.n_experts * 3 * self.d_model * self.d_ff_expert * \
            self.layer_pattern.count("moe")
        dense_like += self.top_k * 3 * self.d_model * self.d_ff_expert * \
            self.layer_pattern.count("moe")
        return dense_like


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
