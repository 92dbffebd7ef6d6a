"""The port's op library (``paddle_tpu/ops/__init__.py``).

Plain functions on torch tensors, exported as the reference exports
them: ``creation``, ``math``, ``reduction`` and ``manipulation`` whole.
The reference's dispatch registry and autotuner are not ported (each op
calls torch directly), nor are its other op modules yet (ROADMAP.md).
The hand-written CUDA kernels and their wrappers live in ``ops.kernels``.
"""

from paddle_tpu_torch.ops import creation, manipulation, math, reduction  # noqa: F401
from paddle_tpu_torch.ops.creation import *  # noqa: F401,F403
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403
from paddle_tpu_torch.ops.reduction import *  # noqa: F401,F403
from paddle_tpu_torch.ops.manipulation import *  # noqa: F401,F403
