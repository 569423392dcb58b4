"""How many lanes share one quadrature point in the hand-written kernels.

csrc/freegas_sab.cu (one y-node of one row) and csrc/cm_pointwise.cu (one
outer node of one row) give each point of a tile to a group of G lanes, G in
LANE_GROUPS, a template parameter of the kernel chosen at launch. The
wrappers choose G here, and scripts/torch_profile_deck.py --plan
reports the same choice for every launch of a deck without a card.
"""

from __future__ import annotations

from functools import lru_cache

import torch

LANE_GROUPS = (1, 2, 4, 8)
H100_SMS = 132  # streaming multiprocessors of an H100 SXM
WARPS_PER_SM = 32  # the warps in flight a tile should give each SM


def lane_group(points: int, sms: int = H100_SMS) -> int:
    """The smallest G of LANE_GROUPS whose points x G lanes fill `sms` SMs with
    WARPS_PER_SM warps each; the largest G where none does."""
    want = sms * WARPS_PER_SM * 32
    for g in LANE_GROUPS:
        if points * g >= want:
            return g
    return LANE_GROUPS[-1]


@lru_cache(maxsize=16)
def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_lanes(name: str, lanes) -> None:
    if lanes is not None and lanes not in LANE_GROUPS:
        raise ValueError(f"{name}: lanes must be one of {LANE_GROUPS} or None, got {lanes!r}")
