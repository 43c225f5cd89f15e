"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/strategy.py``, which it copies).

Reference parity: paddle.distributed.fleet.DistributedStrategy
(fleet/base/distributed_strategy.py backed by distributed_strategy.proto)
— the knob tree for hybrid parallelism: a typed dataclass tree with
the field names the LLM recipes use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["DistributedStrategy", "HybridConfig", "ShardingConfig",
           "RecomputeConfig", "AmpConfig"]


@dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1          # sequence/context parallel axis
    ep_degree: int = 1           # expert parallel (MoE)


@dataclass
class ShardingConfig:
    sharding_degree: int = 1
    stage: int = 1               # ZeRO stage 1/2/3


@dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: Optional[list] = None


@dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O2"


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs: Dict[str, Any] = {}
        self._hybrid = HybridConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.amp = False
        self.amp_configs = AmpConfig()
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.find_unused_parameters = False

    @property
    def hybrid(self) -> HybridConfig:
        # hybrid_configs dict (recipe style) overrides the dataclass
        h = HybridConfig()
        for k, v in self.hybrid_configs.items():
            if hasattr(h, k):
                setattr(h, k, int(v))
        return h

    def __repr__(self):
        h = self.hybrid
        return (f"DistributedStrategy(dp={h.dp_degree}, mp={h.mp_degree}, "
                f"pp={h.pp_degree}, sharding={h.sharding_degree}, "
                f"sep={h.sep_degree}, ep={h.ep_degree})")
