"""``fleet`` of the port: its ``utils.recompute`` (activation
rematerialization) and the ``DistributedStrategy`` tree. The fleet
launcher, meta-optimizers and wrappers of ``paddle_tpu/distributed/fleet``
are later work."""

from paddle_tpu_torch.distributed.fleet import utils
from paddle_tpu_torch.distributed.strategy import DistributedStrategy

__all__ = ["utils", "DistributedStrategy"]
