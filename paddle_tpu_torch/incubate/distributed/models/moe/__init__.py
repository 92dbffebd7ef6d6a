"""Mixture-of-Experts on one device (the port of
``paddle_tpu/incubate/distributed/models/moe``)."""

from .gate import (BaseGate, ExpertChoiceGate, GShardGate,
                   NaiveGate, SwitchGate)
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import (ExpertLayer, MoELayer, get_moe_dispatch_mode,
                        moe_dispatch_mode)

__all__ = ["MoELayer", "ExpertLayer", "moe_dispatch_mode",
           "get_moe_dispatch_mode", "BaseGate", "NaiveGate", "GShardGate",
           "SwitchGate", "ExpertChoiceGate", "ClipGradForMOEByGlobalNorm"]
