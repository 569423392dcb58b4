"""End-of-run metrics block (SURVEY.md section 5, observability).

Key observables:
  - nuclide-group-moments/sec: the north-star throughput metric
    (BASELINE.json:2). Moment count is computed analytically
    (NE x (L+1) x G x n_temperatures), never sampled.
  - padding efficiency: real/padded element ratio of the knot rows.
  - device memory high-water (torch.cuda.max_memory_allocated on a CUDA
    run; None on the CPU), per-phase wall clock.
"""

from __future__ import annotations

import json
from collections import Counter
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

from ndpp_tpu_torch.utils.timer import PhaseTimers


@dataclass
class RunMetrics:
    nuclides_done: int = 0
    nuclides_quarantined: int = 0
    moments_computed: int = 0  # NE*(L+1)*G summed over nuclides/temps
    wall_seconds: float = 0.0
    phase_seconds: dict[str, float] = field(default_factory=dict)
    padding_real_elements: int = 0
    padding_total_elements: int = 0
    device_mem_highwater_bytes: int | None = None
    # Fine-grained sub-phase spans (prep/dispatch/device-wait per kernel
    # family), merged into phase_seconds at run end. Drivers record through
    # RunMetrics.span so a None metrics costs nothing.
    timers: PhaseTimers = field(default_factory=PhaseTimers, repr=False)
    # outer-panel chunk -> number of cm_moments_pointwise tiles dispatched
    # with it (continuum_driver picks the chunk from a byte budget; only the
    # plain CPU path reads it, the CUDA kernel takes a tile whole)
    continuum_chunks: Counter = field(default_factory=Counter, repr=False)

    def span(self, name: str):
        return self.timers.span(name)

    @staticmethod
    def span_or_null(metrics: "RunMetrics | None", name: str):
        return metrics.timers.span(name) if metrics is not None else nullcontext()

    @property
    def moments_per_sec(self) -> float:
        return self.moments_computed / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def padding_efficiency(self) -> float:
        if self.padding_total_elements == 0:
            return 1.0
        return self.padding_real_elements / self.padding_total_elements

    def record_padding(self, real: int, total: int) -> None:
        self.padding_real_elements += int(real)
        self.padding_total_elements += int(total)

    def capture_device_mem(self, devices) -> None:
        """Peak bytes the caching allocator handed out on any one of the CUDA
        devices since the last reset_peak_memory_stats (the driver resets at
        run start)."""
        peaks = [int(torch.cuda.max_memory_allocated(d)) for d in devices if d.type == "cuda"]
        if peaks:
            self.device_mem_highwater_bytes = max(peaks)

    def to_dict(self) -> dict:
        return {
            "nuclides_done": self.nuclides_done,
            "nuclides_quarantined": self.nuclides_quarantined,
            "moments_computed": self.moments_computed,
            "wall_seconds": self.wall_seconds,
            "nuclide_group_moments_per_sec": self.moments_per_sec,
            "padding_efficiency": self.padding_efficiency,
            "device_mem_highwater_bytes": self.device_mem_highwater_bytes,
            "phase_seconds": self.phase_seconds,
        }

    def json_line(self) -> str:
        return json.dumps(self.to_dict())
