"""``paddle_tpu_torch.testing`` — test-only support machinery.

Hosts the deterministic fault-injection harness
(:mod:`~paddle_tpu_torch.testing.fault_injection`). Nothing in here runs
unless a test arms it; production code paths that expose fault points
call into a registry that is empty by default.
"""

from paddle_tpu_torch.testing import fault_injection  # noqa: F401

__all__ = ["fault_injection"]
