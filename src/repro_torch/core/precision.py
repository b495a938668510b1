"""Precision policy: parse and represent WxAyKVz mixed-precision formats.

Port of ``repro.core.precision`` with torch dtypes.  "WxAyKVz" denotes
x-bit weights, y-bit activations and a z-bit KV cache; every combination
parses and the serving engine runs every one.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

#: storage dtype, bits, packed (2 values per int8 container along the
#: quantized axis), is_float
_WEIGHT_FORMATS = {
    "w4":   dict(dtype=torch.int8, bits=4, packed=True, is_float=False),
    "w8":   dict(dtype=torch.int8, bits=8, packed=False, is_float=False),
    "wfp8": dict(dtype=torch.float8_e4m3fn, bits=8, packed=False,
                 is_float=True),
    "w16":  dict(dtype=torch.bfloat16, bits=16, packed=False, is_float=True),
}

_ACT_FORMATS = {
    "a8":   dict(dtype=torch.int8, bits=8, packed=False, is_float=False),
    "afp8": dict(dtype=torch.float8_e4m3fn, bits=8, packed=False,
                 is_float=True),
    "a16":  dict(dtype=torch.bfloat16, bits=16, packed=False, is_float=True),
}

_KV_FORMATS = {
    "kv4":   dict(dtype=torch.int8, bits=4, packed=True, is_float=False),
    "kv8":   dict(dtype=torch.int8, bits=8, packed=False, is_float=False),
    "kvfp8": dict(dtype=torch.float8_e5m2, bits=8, packed=False,
                  is_float=True),
    "kv16":  dict(dtype=torch.bfloat16, bits=16, packed=False, is_float=True),
}

_POLICY_RE = re.compile(r"^(w4|w8|wfp8|w16)(a8|afp8|a16)(kv4|kv8|kvfp8|kv16)$")


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """One precision atom (weights, activations or KV)."""

    name: str
    dtype: torch.dtype
    bits: int
    packed: bool      # two 4-bit values per int8 container
    is_float: bool

    @property
    def bytes_per_value(self) -> float:
        """Storage bytes of one value (0.5 for the nibble-packed formats)."""
        return self.bits / 8.0

    @property
    def qmax(self) -> float:
        """Max representable magnitude for symmetric quantization."""
        if self.is_float:
            return float(torch.finfo(self.dtype).max)
        return float(2 ** (self.bits - 1) - 1)


def _spec(table, name) -> FormatSpec:
    return FormatSpec(name=name, **table[name])


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """A full WxAyKVz policy, e.g. ``PrecisionPolicy.parse("w4a16kv8")``.

    ``compute_dtype`` is bf16, as in the JAX package.
    """

    weights: FormatSpec
    acts: FormatSpec
    kv: FormatSpec
    weight_group: int = 128     # per-group quant granularity along K
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def parse(cls, fmt: str, *, weight_group: int = 128) -> "PrecisionPolicy":
        """Parse a ``WxAyKVz`` name (raises ``ValueError`` when malformed)."""
        m = _POLICY_RE.match(fmt.lower().strip())
        if not m:
            raise ValueError(
                f"Bad precision format {fmt!r}; expected WxAyKVz, e.g. w4a16kv8 "
                f"with w∈{sorted(_WEIGHT_FORMATS)}, a∈{sorted(_ACT_FORMATS)}, "
                f"kv∈{sorted(_KV_FORMATS)}")
        w, a, kv = m.groups()
        return cls(weights=_spec(_WEIGHT_FORMATS, w),
                   acts=_spec(_ACT_FORMATS, a),
                   kv=_spec(_KV_FORMATS, kv),
                   weight_group=weight_group)

    @property
    def name(self) -> str:
        """The policy's ``WxAyKVz`` name."""
        return f"{self.weights.name}{self.acts.name}{self.kv.name}"

    @property
    def int8_matmul(self) -> bool:
        """Integer weights (bits <= 8) × integer 8-bit activations take the
        s8×s8→s32 GEMM (W4 nibbles unpack to valid s8 operands).  Float
        activations (afp8) are not quantized at all: they take the A16
        GEMM in bf16, as in the JAX package."""
        return (not self.weights.is_float and self.weights.bits <= 8
                and not self.acts.is_float and self.acts.bits == 8)

    def weight_bytes(self, n_params: int) -> int:
        """Storage bytes of ``n_params`` quantized weights (scales not
        included)."""
        return int(n_params * self.weights.bytes_per_value)


# Paper-faithful default serving format (headline format, §5.2 W4A16KV8).
DEFAULT_SERVING = "w4a16kv8"
TRAINING = "w16a16kv16"

_ALIASES = {
    "default": DEFAULT_SERVING,
    "training": TRAINING,
    "qserve": "w4a8kv4",
    "turbomind-optimal": "w4a16kv4",
}


def get_policy(fmt: Optional[str] = None, **kw) -> PrecisionPolicy:
    """Policy by name or alias (default ``w4a16kv8``)."""
    fmt = fmt or DEFAULT_SERVING
    fmt = _ALIASES.get(fmt, fmt)
    return PrecisionPolicy.parse(fmt, **kw)
