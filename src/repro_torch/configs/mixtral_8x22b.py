"""mixtral-8x22b [moe] — 8 experts top-2, SWA (arXiv:2401.04088; hf).
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768. Follows the ASSIGNED
spec (SWA on, window 4096) — the sliding window bounds the decode cache, so
long_500k runs with a 4096-slot ring buffer.
A copy of `repro/configs/mixtral_8x22b.py`."""
from repro_torch.models.config import ArchConfig, MoESpec, lm_shapes

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="decoder",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, rope_theta=1_000_000.0,
    window_pattern=(4096,),
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=16384),
    shapes=lm_shapes(long_ok=True),
)
