"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191; hf).
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. Vision tower is a
STUB: input_specs feeds precomputed patch embeddings scattered into the
token stream; M-RoPE sections (16, 24, 24) over hd=128.
A copy of `repro/configs/qwen2_vl_2b.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="decoder",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), num_patches=256, frontend="vision",
    tie_embeddings=True,
    shapes=lm_shapes(long_ok=False),
)
