"""repro_torch.serve — the sketch-serving engine (port of `repro.serve`).

  queue -> batcher -> one dispatch per tick -> sketch store -> retrieval

`DynamicBatcher` (lane-keyed, max-batch / max-latency flush),
`OperatorCache` (LRU over (spec, seed), bitwise regeneration),
`SketchStore` (device-resident rows, tiled top-m and pairwise queries
with the Thm-1 bound), `SketchServer` tying them together, and
`synth_trace` / `replay`. CLI: `python -m repro_torch.launch.serve_rp`.
"""
from .batcher import DynamicBatcher, LaneKey, SketchRequest, structure_tag
from .cache import CacheStats, OperatorCache
from .config import ServeConfig
from .engine import SketchServer
from .loadgen import TraceEvent, replay, synth_trace
from .store import PairwiseResult, QueryResult, SketchStore

__all__ = [
    "CacheStats", "DynamicBatcher", "LaneKey", "OperatorCache",
    "PairwiseResult", "QueryResult", "ServeConfig", "SketchRequest",
    "SketchServer", "SketchStore", "TraceEvent", "replay", "structure_tag",
    "synth_trace",
]
