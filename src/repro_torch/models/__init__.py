"""repro_torch.models — the reference's four model families in PyTorch
(port of `repro.models`): the decoder, mamba2, the RG-LRU hybrid and the
whisper encoder-decoder."""
from .api import Model, build_model, from_numpy_params, input_specs
from .config import ArchConfig, MoESpec, ShapeSpec, lm_shapes

__all__ = ["ArchConfig", "Model", "MoESpec", "ShapeSpec", "build_model",
           "from_numpy_params", "input_specs", "lm_shapes"]
