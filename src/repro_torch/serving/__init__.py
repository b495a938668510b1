"""Public serving surface: engine, config, request/output types."""
from .config import EngineConfig, EngineError                  # noqa: F401
from .engine import Engine, quantize_params, percentile_stats  # noqa: F401
from .request import (FinishReason, Request, RequestOutput,    # noqa: F401
                      SamplingParams, Status)
from .scheduler import Scheduler                               # noqa: F401

from repro_torch.core.paged_kvcache import (                   # noqa: F401
    BlockAllocator, OutOfBlocksError, PagedKVCache)
