"""repro_torch.models — the dense decoder-only transformer in PyTorch
(port of the dense path of `repro.models`)."""
from .api import Model, build_model, input_specs
from .config import ArchConfig, MoESpec, ShapeSpec, lm_shapes

__all__ = ["ArchConfig", "Model", "MoESpec", "ShapeSpec", "build_model",
           "input_specs", "lm_shapes"]
