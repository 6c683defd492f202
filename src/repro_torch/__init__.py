"""repro_torch — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

Each subpackage mirrors its `repro` counterpart (`core`, `rp`, `kernels`,
`serve`, `launch`), so every module has one obvious reference to be
tested against. The package imports torch, numpy and the standard library
only. Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on a CUDA tensor every kernel wrapper launches its
hand-written kernel or raises.
"""
