"""Three-term roofline on the NVIDIA H100 SXM (the reference's
``repro.utils.roofline``, with the card's peaks for the TPU's):

    compute term    = sum over compute classes of FLOPs / the class's peak
    memory term     = bytes / HBM rate
    collective term = link bytes / NVLink rate (one direction)

The FLOPs and bytes come from ``utils.op_cost`` (per-chip: a mesh's
totals divided by its chips); a compute class is the peak an operation
runs at, picked by its dtype: "f32" (float32 on the CUDA cores, also a
float32 GEMM without TF32), "tf32" (float32 products on the tensor
cores: a GEMM with TF32 allowed, the split-TF32 kernels), "bf16" (dense
bfloat16 or float16 on the tensor cores).

MODEL_FLOPS = 6 N D for training, 2 N D per prefilled or decoded token
(N the parameters, the active ones for an MoE); MODEL_FLOPS over the
counted FLOPs is the useful-compute ratio.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12                # float32 on the CUDA cores
TF32_TC_FLOP_PER_S = 495e12           # dense TF32 on the tensor cores
BF16_TC_FLOP_PER_S = 989e12           # dense bfloat16 on the tensor cores
NVLINK_BYTES_PER_S = 450e9            # NVLink 4, one direction of 900 GB/s

PEAKS = {"f32": F32_FLOP_PER_S, "tf32": TF32_TC_FLOP_PER_S,
         "bf16": BF16_TC_FLOP_PER_S}


@dataclass
class Roofline:
    name: str
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    flops_per_chip: float
    bytes_per_chip: float
    link_bytes_per_chip: Optional[float]
    peak_flops: float
    model_flops: Optional[float] = None
    n_chips: int = 1
    flops_by_class: Dict[str, float] = field(default_factory=dict)
    collective_note: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s or 0.0}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The bound that needs no overlap: the longest of the terms."""
        return max(self.compute_s, self.memory_s, self.collective_s or 0.0)

    @property
    def useful_flop_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops_per_chip == 0:
            return None
        return self.model_flops / (self.flops_per_chip * self.n_chips)

    @property
    def mfu_bound(self) -> Optional[float]:
        """MODEL_FLOPS / (chips peak step_time): the best MFU this program
        could reach, perfectly overlapped."""
        if self.model_flops is None or self.step_time_s == 0:
            return None
        return self.model_flops / (self.n_chips * self.peak_flops
                                   * self.step_time_s)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "collective_note": self.collective_note,
            "dominant": self.dominant, "step_time_s": self.step_time_s,
            "flops_per_chip": self.flops_per_chip,
            "flops_by_class": self.flops_by_class,
            "bytes_per_chip": self.bytes_per_chip,
            "link_bytes_per_chip": self.link_bytes_per_chip,
            "peak_flops": self.peak_flops,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
            "n_chips": self.n_chips,
        }


def from_cost(name: str, cost, *, model_flops: Optional[float] = None,
              n_chips: int = 1, peak: str = "bf16",
              collectives: bool = True, peaks: Optional[dict] = None,
              hbm: float = HBM_BYTES_PER_S,
              link: float = NVLINK_BYTES_PER_S) -> Roofline:
    """The roofline of an ``op_cost.Cost`` (the whole program's, over
    ``n_chips``). ``peak``: the class whose rate prices ``mfu_bound``
    (the model's compute dtype). ``collectives=False`` where none could
    be issued (a run on the meta device): the term is None."""
    peaks = PEAKS if peaks is None else peaks
    by_class = {c: f / n_chips for c, f in cost.flops_by_class.items()}
    compute = sum(f / peaks[c] for c, f in by_class.items())
    nbytes = cost.bytes / n_chips
    link_bytes = cost.link_bytes / n_chips if collectives else None
    return Roofline(
        name=name, compute_s=compute, memory_s=nbytes / hbm,
        collective_s=None if link_bytes is None else link_bytes / link,
        flops_per_chip=cost.flops / n_chips, bytes_per_chip=nbytes,
        link_bytes_per_chip=link_bytes, peak_flops=peaks[peak],
        model_flops=model_flops, n_chips=n_chips, flops_by_class=by_class,
        collective_note="" if collectives else
        "not measured: no collective is issued on the meta device")


def model_flops_estimate(n_params: float, tokens: float, kind: str,
                         n_active_params: Optional[float] = None) -> float:
    """6 N D for train, 2 N D for inference-style passes."""
    n = n_active_params if n_active_params is not None else n_params
    factor = 6.0 if kind == "train" else 2.0
    return factor * n * tokens
