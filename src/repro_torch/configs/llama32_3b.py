"""llama3.2-3b [dense] — small llama3 (hf:meta-llama/Llama-3.2-1B; unverified).
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256; tied embeddings.
A copy of `repro/configs/llama32_3b.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="llama3.2-3b", family="decoder",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, rope_theta=500_000.0, tie_embeddings=True,
    shapes=lm_shapes(long_ok=False),
)
