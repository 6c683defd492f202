"""repro_torch.data — the synthetic LM stream (copy of `repro.data`'s)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
