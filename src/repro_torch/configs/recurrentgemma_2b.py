"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 (arXiv:2402.19427;
hf). 26L d_model=2560 10H (MQA kv=1, hd=256) d_ff=7680 vocab=256000;
rnn width 2560; local window 2048; pattern (rec, rec, attn); GeGLU.
O(1)-state decode -> runs long_500k.
A copy of `repro/configs/recurrentgemma_2b.py`."""
from repro_torch.models.config import ArchConfig, lm_shapes

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, mlp="geglu", rnn_width=2560, conv_width=4,
    window_pattern=(2048,), block_pattern=("rec", "rec", "attn"),
    embed_scale=True, tie_embeddings=True,
    shapes=lm_shapes(long_ok=True),
)
