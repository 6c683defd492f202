"""mamba2-1.3b [ssm] — SSD, attention-free (arXiv:2405.21060; unverified).
48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128, head_dim=64, expand=2.
O(1)-state decode -> runs long_500k.
A copy of `repro/configs/mamba2_13b.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, conv_width=4, tie_embeddings=True,
    shapes=lm_shapes(long_ok=True),
)
