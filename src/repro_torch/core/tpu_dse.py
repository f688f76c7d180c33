"""Beyond-paper: MOSAIC's DSE methodology re-targeted at the training
mesh (a port of ``repro/core/tpu_dse.py``, which keeps its name so that a
reader finds the counterpart; the rates here are the H100's).

The paper searches NPU tile compositions with analytical roofline cost
models; this module applies the same methodology to the training
framework itself: knobs = (data-parallel width, tensor-parallel width,
microbatches, remat policy), cost model = the three roofline terms of
``launch.roofline``.  The search returns the predicted-fastest sharding
for a (ModelConfig, batch, seq) training cell.

Rates: one NVIDIA H100 SXM per device, from its data sheet (dense bf16,
HBM3, NVLink 4 per direction), and ``hbm_gib`` 80 (H100 80GB).  An axis
that crosses an 8-GPU node runs over InfiniBand, which is slower than
the NVLink rate assumed here.  Data-sheet figures, not measurements.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List

from ..models.config import ModelConfig

__all__ = ["MeshKnobs", "MeshCost", "predict_cost", "search_mesh"]

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12         # HBM3 B/s, H100 SXM data sheet
LINK_BW = 450e9          # NVLink 4 B/s per direction (900 GB/s both ways)


@dataclasses.dataclass(frozen=True)
class MeshKnobs:
    dp: int
    tp: int
    microbatches: int = 1
    remat: bool = True


@dataclasses.dataclass
class MeshCost:
    knobs: MeshKnobs
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_gib: float
    fits: bool

    @property
    def step_s(self) -> float:
        # double-buffered overlap of compute against the slower of
        # memory/collective traffic (Eq. 5's max-combine, applied to chips)
        return max(self.compute_s, self.memory_s, self.collective_s)


def predict_cost(cfg: ModelConfig, knobs: MeshKnobs, global_batch: int,
                 seq_len: int, hbm_gib: float = 80.0) -> MeshCost:
    """Analytical three-term roofline for one training step."""
    chips = knobs.dp * knobs.tp
    n = cfg.param_count()
    if cfg.n_experts:
        f = cfg.moe_d_ff or cfg.d_ff
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        n_active = n - moe_layers * (cfg.n_experts - cfg.top_k) * 3 \
            * cfg.d_model * f
    else:
        n_active = n
    tokens = global_batch * seq_len
    flops = 6.0 * n_active * tokens * (4.0 / 3.0 if knobs.remat else 1.0)
    t_c = flops / (chips * PEAK_FLOPS)

    # HBM traffic: params + grads + optimizer read/write per step, plus one
    # activation sweep per microbatch
    state_bytes = n * (2 + 2 + 8)  # bf16 p + bf16 g + fp32 m,v
    act_bytes = tokens * cfg.d_model * 2 * cfg.n_layers \
        * (2 if knobs.remat else 6)
    t_m = (state_bytes + act_bytes) / (chips * HBM_BW)

    # collectives: TP all-gathers/reduce-scatters per layer + DP grad
    # all-reduce (ring: 2(p-1)/p of the shard)
    act_per_layer = (global_batch / knobs.dp) * seq_len * cfg.d_model * 2
    tp_bytes = 4.0 * cfg.n_layers * act_per_layer * (knobs.tp - 1) \
        / max(knobs.tp, 1)
    dp_bytes = 2.0 * (n * 2 / knobs.tp) * (knobs.dp - 1) / max(knobs.dp, 1)
    t_l = (tp_bytes + dp_bytes) / (chips * LINK_BW)

    # memory check
    per_chip = state_bytes / chips \
        + act_bytes / chips / knobs.microbatches
    fits = per_chip <= hbm_gib * 2**30
    return MeshCost(knobs, t_c, t_m, t_l, per_chip / 2**30, fits)


def search_mesh(cfg: ModelConfig, chips: int, global_batch: int,
                seq_len: int, hbm_gib: float = 80.0) -> List[MeshCost]:
    """Enumerate (dp, tp, microbatch, remat) over ``chips`` and rank by the
    predicted step time -- MOSAIC's sweep stage on mesh knobs."""
    out = []
    tps = [t for t in (1, 2, 4, 8, 16, 32) if chips % t == 0]
    for tp, mb, remat in itertools.product(tps, (1, 2, 4, 8),
                                           (False, True)):
        dp = chips // tp
        if global_batch % (dp * mb):
            continue
        out.append(predict_cost(cfg, MeshKnobs(dp, tp, mb, remat),
                                global_batch, seq_len, hbm_gib))
    out.sort(key=lambda c: (not c.fits, c.step_s, c.collective_s))
    return out
