"""Architecture configuration schema consumed by the model families and the
launch layer (a copy of `repro/models/config.py`; the port imports nothing
of the reference). One instance per architecture lives in
repro_torch/configs/.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

GLOBAL_WINDOW = 1 << 30  # sentinel: "no window" as a dynamic window value


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual_ff: Optional[int] = None  # arctic dense-MoE hybrid
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str            # train_4k / prefill_32k / decode_32k / long_500k
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'
    skip: Optional[str] = None  # reason if inapplicable for this arch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str          # 'decoder' | 'encdec' | 'hybrid' | 'ssm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"                     # 'swiglu' | 'geglu' | 'gelu'
    norm: str = "rms"                       # 'rms' | 'ln'
    norm_offset: float = 0.0                # gemma-style (1 + w) rmsnorm
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norm: bool = False                 # gemma2 post-block rmsnorms
    embed_scale: bool = False               # gemma-style sqrt(D) embed scaling
    window_pattern: tuple = (None,)         # cycles over layers; None=global
    moe: Optional[MoESpec] = None
    mrope_sections: Optional[tuple] = None  # qwen2-vl (t,h,w) freq sections
    # hybrid (recurrentgemma / griffin)
    rnn_width: Optional[int] = None
    block_pattern: Optional[tuple] = None   # e.g. ('rec','rec','attn')
    # ssm (mamba2)
    ssm_state: Optional[int] = None
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_width: int = 4
    # enc-dec (whisper)
    encoder_layers: Optional[int] = None
    encoder_seq: Optional[int] = None       # e.g. 1500 audio frames
    # modality frontend stub: 'audio' (frames) | 'vision' (patches)
    frontend: Optional[str] = None
    num_patches: int = 256                  # vlm stub: patches per image
    tie_embeddings: bool = False
    policy: str = "mixed"                   # 'mixed' | 'lean'
    shapes: tuple = ()

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def window_for_layer(self, i: int) -> int:
        w = self.window_pattern[i % len(self.window_pattern)]
        return GLOBAL_WINDOW if w is None else int(w)

    def window_array(self):
        return [self.window_for_layer(i) for i in range(self.n_layers)]

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: no shape {name}; have "
                       f"{[s.name for s in self.shapes]}")

    # -- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) -------
    def param_count(self) -> int:
        D = self.d_model
        F, V, L = self.d_ff, self.vocab, self.n_layers
        total = V * D + D  # embed + final norm
        if not self.tie_embeddings:
            total += D * V
        if self.family == "ssm":
            d_in = self.ssm_expand * D
            H = d_in // self.ssm_head_dim
            conv_ch = d_in + 2 * self.ssm_groups * self.ssm_state
            per = (D * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + H)
                   + conv_ch * self.conv_width + 3 * H + d_in + d_in * D + D)
            return total + L * per
        hd = self.hd
        Hq, Hkv = self.n_heads, self.n_kv_heads
        attn = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
        if self.qkv_bias:
            attn += (Hq + 2 * Hkv) * hd
        if self.mlp in ("swiglu", "geglu"):
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F + F + D
        if self.family == "hybrid":
            dr = self.rnn_width
            rec = (D * dr * 2 + dr * self.conv_width + 2 * dr * dr // 1
                   + 2 * dr + dr * D + D)  # approx: in x2, conv, gates, out
            att = attn + 2 * D
            m = mlp + D
            pat = self.block_pattern
            n_rec = sum(1 for i in range(L) if pat[i % len(pat)] == "rec")
            n_att = L - n_rec
            return total + n_rec * (rec + m) + n_att * (att + m)
        per_layer = attn + 2 * D
        if self.post_norm:
            per_layer += 2 * D
        if self.moe is not None:
            e = self.moe
            per_layer += D * e.num_experts  # router
            per_layer += e.num_experts * 3 * D * e.d_ff_expert
            if e.dense_residual_ff:
                per_layer += 3 * D * e.dense_residual_ff
        else:
            per_layer += mlp
        total += L * per_layer
        if self.family == "encdec":
            enc_per = attn + mlp + 4 * D + (D * Hq * hd + Hq * hd * D
                                            + 2 * D * Hkv * hd)  # + cross attn
            total += (self.encoder_layers or 0) * enc_per
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        inactive = self.n_layers * (e.num_experts - e.top_k) * 3 * self.d_model * e.d_ff_expert
        return self.param_count() - inactive


LM_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def lm_shapes(long_ok: bool, reason: str = "pure full attention — 512k KV "
              "cache/quadratic prefill infeasible; see DESIGN.md") -> tuple:
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not long_ok:
            out.append(dataclasses.replace(s, skip=reason))
        else:
            out.append(s)
    return tuple(out)
