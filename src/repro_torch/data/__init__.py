"""repro_torch.data — the synthetic LM stream and the byte tokenizer
(copies of `repro.data`'s)."""
from .pipeline import DataConfig, SyntheticLM
from .tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "DataConfig", "SyntheticLM"]
