"""arctic-480b [moe] — 128 experts top-2 + dense residual
(hf:Snowflake/snowflake-arctic-base; hf). 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000. Dense-MoE hybrid: per layer, dense FFN(4864) and the
top-2-of-128 MoE both feed the residual stream. 'lean' bf16 policy on the
single-pod mesh (see DESIGN.md memory notes).
A copy of `repro/configs/arctic_480b.py`."""
from repro_torch.models.config import ArchConfig, MoESpec, lm_shapes

CONFIG = ArchConfig(
    name="arctic-480b", family="decoder",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000, rope_theta=10000.0,
    moe=MoESpec(num_experts=128, top_k=2, d_ff_expert=4864,
                dense_residual_ff=4864),
    policy="lean",
    shapes=lm_shapes(long_ok=False),
)
