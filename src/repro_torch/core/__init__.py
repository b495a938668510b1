"""Core mixed-precision inference library: the JAX package's public surface.

  PrecisionPolicy / get_policy          — WxAyKVz format handling
  pack_weight / PackedWeight            — offline hardware-aware packing
                                          (§4.1)
  mp_matmul                             — mixed-precision GEMM (§3.4)
  KVCache / init_cache / append         — quantized KV cache (dense slab)
  PagedKVCache / BlockAllocator         — block-pooled quantized KV cache
  kv_bytes                              — resident bytes of either, or of a
                                          recurrent state
  prefill_attention / decode_attention  — mixed-precision attention pipeline

``cache_spec`` is the slab with no storage (meta tensors), the dry-run's
stand-in (``launch/dryrun.py``).

``gemm`` and ``attention`` call the kernel wrappers, which import this
package's other modules, so their names load at first use (an eager import
here would close that cycle for a caller that imports a kernel module
first).
"""
import importlib

from .precision import (PrecisionPolicy, FormatSpec, get_policy,
                        DEFAULT_SERVING)
from .packing import (PackedWeight, pack_weight, unpack_weight,
                      dequantize_packed, quantize_rowmajor)
from .kvcache import KVCache, init_cache, cache_spec, append, store_dim
from .paged_kvcache import (PagedKVCache, BlockAllocator, OutOfBlocksError,
                            init_paged, append_paged, gather_view,
                            blocks_needed, kv_bytes)

#: names of the modules that reach the kernels, loaded at first use
_LAZY = {"mp_matmul": "gemm", "dense_matmul": "gemm",
         "prefill_attention": "attention", "decode_attention": "attention",
         "cross_attention": "attention", "flash_attention": "attention"}


def __getattr__(name):
    """The names of ``gemm`` and ``attention`` (module docstring)."""
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PrecisionPolicy", "FormatSpec", "get_policy", "DEFAULT_SERVING",
    "PackedWeight", "pack_weight", "unpack_weight", "dequantize_packed",
    "quantize_rowmajor", "mp_matmul", "dense_matmul",
    "KVCache", "init_cache", "cache_spec", "append", "store_dim",
    "PagedKVCache", "BlockAllocator", "OutOfBlocksError", "init_paged",
    "append_paged", "gather_view", "blocks_needed", "kv_bytes",
    "prefill_attention", "decode_attention", "cross_attention",
    "flash_attention",
]
