"""DistributedStrategy — the port of ``paddle_tpu/distributed/strategy.py``.

The typed feature-flag tree: one dataclass per feature's config, and the
reference's dict round-trip (a ``*_configs`` attribute takes a dict, in
the constructor or by assignment). It holds no device state, so it is
the reference's tree field for field. The one-card
``ShardedTrainer`` honours ``recompute``, ``amp`` and ``gradient_merge``,
takes ``sharding`` as a no-op, and refuses the rest
(``distributed/trainer.py``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict

__all__ = ["DistributedStrategy", "HybridConfig", "ShardingConfig",
           "RecomputeConfig", "AMPConfig", "PipelineConfig", "MoEConfig",
           "GradientMergeConfig", "LocalSGDConfig", "AdaptiveLocalSGDConfig"]


@dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1  # sequence/context parallel — capability gap closed

    @property
    def world(self) -> int:
        return (self.dp_degree * self.mp_degree * self.pp_degree
                * self.sharding_degree * self.sep_degree)


@dataclass
class ShardingConfig:
    stage: int = 1                 # ZeRO stage 1/2/3
    degree: int = 1
    offload: bool = False
    comm_overlap: bool = True


@dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: list = field(default_factory=list)


@dataclass
class AMPConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 32768.0
    use_dynamic_loss_scaling: bool = True


@dataclass
class PipelineConfig:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"


@dataclass
class MoEConfig:
    enable: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.2
    gate: str = "gshard"


@dataclass
class GradientMergeConfig:
    enable: bool = False
    k_steps: int = 1
    avg: bool = True


@dataclass
class LocalSGDConfig:
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class AdaptiveLocalSGDConfig:
    init_k_steps: int = 1
    begin_step: int = 1
    max_k_steps: int = 16


@dataclass
class LarsConfig:
    lars_coeff: float = 0.001
    lars_weight_decay: float = 0.0005
    epsilon: float = 1e-9
    exclude_from_weight_decay: list = field(default_factory=list)


@dataclass
class DistributedStrategy:
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    sharding: bool = False
    sharding_configs: ShardingConfig = field(default_factory=ShardingConfig)
    recompute: bool = False
    recompute_configs: RecomputeConfig = field(default_factory=RecomputeConfig)
    amp: bool = False
    amp_configs: AMPConfig = field(default_factory=AMPConfig)
    pipeline: bool = False
    pipeline_configs: PipelineConfig = field(default_factory=PipelineConfig)
    moe: bool = False
    moe_configs: MoEConfig = field(default_factory=MoEConfig)
    gradient_merge: bool = False
    gradient_merge_configs: GradientMergeConfig = field(
        default_factory=GradientMergeConfig)
    lars: bool = False
    lars_configs: LarsConfig = field(default_factory=LarsConfig)
    localsgd: bool = False
    localsgd_configs: LocalSGDConfig = field(default_factory=LocalSGDConfig)
    adaptive_localsgd: bool = False
    adaptive_localsgd_configs: AdaptiveLocalSGDConfig = field(
        default_factory=AdaptiveLocalSGDConfig)
    find_unused_parameters: bool = False
    fuse_all_reduce_ops: bool = True     # accepted for parity; XLA fuses
    gradient_scale_configs: Dict[str, Any] = field(
        default_factory=lambda: {"scale_strategy": "avg"})

    def __post_init__(self):
        # accept dicts for sub-configs (matching the reference's
        # strategy.hybrid_configs = {...} assignment style)
        if isinstance(self.hybrid_configs, dict):
            self.hybrid_configs = HybridConfig(**self.hybrid_configs)
        if isinstance(self.sharding_configs, dict):
            self.sharding_configs = ShardingConfig(**self.sharding_configs)
        if isinstance(self.recompute_configs, dict):
            self.recompute_configs = RecomputeConfig(**self.recompute_configs)
        if isinstance(self.amp_configs, dict):
            self.amp_configs = AMPConfig(**self.amp_configs)
        if isinstance(self.pipeline_configs, dict):
            self.pipeline_configs = PipelineConfig(**self.pipeline_configs)
        if isinstance(self.moe_configs, dict):
            self.moe_configs = MoEConfig(**self.moe_configs)
        if isinstance(self.gradient_merge_configs, dict):
            self.gradient_merge_configs = GradientMergeConfig(
                **self.gradient_merge_configs)
        if isinstance(self.lars_configs, dict):
            self.lars_configs = LarsConfig(**self.lars_configs)
        if isinstance(self.localsgd_configs, dict):
            self.localsgd_configs = LocalSGDConfig(**self.localsgd_configs)
        if isinstance(self.adaptive_localsgd_configs, dict):
            self.adaptive_localsgd_configs = AdaptiveLocalSGDConfig(
                **self.adaptive_localsgd_configs)

    def __setattr__(self, name, value):
        # allow dict assignment post-init too
        if name.endswith("_configs") and isinstance(value, dict):
            current = getattr(self, name, None)
            if current is not None and not isinstance(current, dict):
                value = type(current)(**value)
        object.__setattr__(self, name, value)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def __repr__(self):
        import json

        return "DistributedStrategy" + json.dumps(self.to_dict(), indent=2,
                                                  default=str)
