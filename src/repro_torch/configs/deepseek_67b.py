"""deepseek-67b [dense] — llama-arch (arXiv:2401.02954; hf).
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
A copy of `repro/configs/deepseek_67b.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="deepseek-67b", family="decoder",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400, rope_theta=10000.0,
    shapes=lm_shapes(long_ok=False),
)
