"""Roofline terms of one step on the card, from the op counter.

Port of ``repro.roofline.analysis``.  Three terms, in seconds:

    compute    = FLOPs / (chips × peak FLOP/s)
    memory     = bytes / (chips × HBM bandwidth)
    collective = collective bytes a device / link bandwidth

The reference reads FLOPs and bytes from the compiled HLO of its dry-run
(``hlo_cost``); the port counts one eager call of the step
(``op_cost``), kernels by their declared cost: on one card
(:func:`analyze_step`: ``chips`` 1, no collectives), or one rank of a
sharded step (:func:`analyze_sharded`, the dry-run's: rank 0's FLOPs and
bytes times the chips, as the reference scales its per-device HLO
counts, and rank 0's collective wire bytes under the reference's ring
model).  :data:`HW` holds the card's published peaks; no TPU constant is
kept here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from .op_cost import Cost, count


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Published constants of one accelerator (dense rates, no sparsity)."""
    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12        # bf16 tensor-core FLOP/s
    int8_ops: float = 1979e12         # int8 tensor-core OP/s
    hbm_bw: float = 3.35e12           # HBM3 bytes/s
    #: NVLink 4: 900 GB/s over 18 links, counted both ways
    link_bw: float = 50e9
    #: the data sheet's 80 GB, read as GiB (``chip_smoke.py`` checks it
    #: against the card's own count)
    hbm_bytes: float = 80 * 2 ** 30


#: NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet); the rates assume its 700 W
#: power limit
HW = Hardware()


@dataclasses.dataclass
class RooflineTerms:
    """The reference's terms, field for field (``hlo_flops`` /
    ``hlo_bytes`` hold the op counter's counts here), plus the counter's
    breakdown in ``cost`` when :func:`analyze_step` made them."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes_per_device: float
    collective_counts: Dict[str, float]
    model_flops: float
    hw: Hardware = HW
    cost: Optional[Cost] = None

    @property
    def compute_s(self) -> float:
        """FLOPs at the card's bf16 peak."""
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def memory_s(self) -> float:
        """Bytes at the card's HBM bandwidth."""
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        """A device's wire bytes serialized over one link."""
        return self.collective_bytes_per_device / self.hw.link_bw

    @property
    def dominant(self) -> str:
        """The largest of the three terms."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is
        useful."""
        return self.model_flops / max(self.hlo_flops, 1.0)

    def row(self) -> dict:
        """The reference's row."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes_dev": self.collective_bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "collectives": self.collective_counts,
        }


def model_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train: forward + backward) or
    2·N_active·D (inference forward), D = tokens processed this step."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n * tokens
    tokens = batch * 1           # decode: one new token per sequence
    return 2.0 * n * tokens


def analyze_step(fn: Callable, *args, arch: str, shape: str, cfg, seq: int,
                 batch: int, kind: str, **kwargs) -> RooflineTerms:
    """Count one call ``fn(*args, **kwargs)`` (``op_cost.count``) and
    return its roofline terms on one card; the counter's breakdown is in
    ``.cost``.  The counterpart of ``analyze_compiled``."""
    _, c = count(fn, *args, **kwargs)
    return RooflineTerms(
        arch=arch, shape=shape, mesh="1", chips=1, hlo_flops=c.flops,
        hlo_bytes=c.bytes, collective_bytes_per_device=0.0,
        collective_counts={}, model_flops=model_flops(cfg, seq, batch, kind),
        cost=c)


def analyze_sharded(cost: Cost, *, arch: str, shape: str, mesh_desc: str,
                    chips: int, cfg, seq: int, batch: int,
                    kind: str) -> RooflineTerms:
    """The roofline terms of a sharded step from one rank's count
    (``op_cost.count`` of its local ops under the mesh): the counterpart
    of ``analyze_compiled`` — ``hlo_flops`` / ``hlo_bytes`` are the
    rank's counts times ``chips`` (every rank taken to do rank 0's work,
    as the reference's per-device HLO counts are scaled),
    ``collective_bytes_per_device`` and ``collective_counts`` the rank's
    collectives (``Cost.collectives``)."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        hlo_flops=float(cost.flops * chips),
        hlo_bytes=float(cost.bytes * chips),
        collective_bytes_per_device=cost.collective_bytes,
        collective_counts=dict(cost.collective_counts),
        model_flops=model_flops(cfg, seq, batch, kind), cost=cost)
