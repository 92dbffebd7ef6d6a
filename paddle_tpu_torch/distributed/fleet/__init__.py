"""``fleet`` of the port: its ``utils.recompute`` (activation
rematerialization). The fleet launcher, strategies and wrappers of
``paddle_tpu/distributed/fleet`` are later work."""

from paddle_tpu_torch.distributed.fleet import utils

__all__ = ["utils"]
