"""gemma2-9b [dense] — local+global alternating, logit softcaps
(arXiv:2408.00118; hf). 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; hd=256; attn softcap 50, final softcap 30; pre+post RMSNorm;
GeGLU; (1+w) norm offset; sqrt(D) embed scaling; tied embeddings.
A copy of `repro/configs/gemma2_9b.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="gemma2-9b", family="decoder",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, mlp="geglu", rope_theta=10000.0,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    norm_offset=1.0, embed_scale=True, tie_embeddings=True,
    window_pattern=(4096, None),
    shapes=lm_shapes(long_ok=False, reason="alternating local/global — "
                     "global layers need the full 512k cache; see DESIGN.md"),
)
