"""whisper-medium [audio] — enc-dec, conv frontend STUB (arXiv:2212.04356;
unverified). 24L(+24 enc) d_model=1024 16H (kv=16 -> MHA) d_ff=4096
vocab=51865; encoder consumes 1500 precomputed frame embeddings.
A copy of `repro/configs/whisper_medium.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, encoder_layers=24, encoder_seq=1500,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=51865, mlp="gelu", norm="ln", frontend="audio",
    tie_embeddings=True,
    shapes=lm_shapes(long_ok=False, reason="full-attention enc-dec decoder; "
                     "512k decoder context infeasible; see DESIGN.md"),
)
