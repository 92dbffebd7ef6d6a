"""One torch intra-op thread per test process.

The port's CPU tests run tiny tensors (gpt_tiny, hidden 32-64), where
torch's default of one intra-op thread per core buys nothing. Under the
suite's ``xdist -n 6`` on an 8-core host, six workers each spreading
torch ops over eight threads oversubscribe the CPU several times over:
the port's tests took 637 s of wall (3355 s summed over tests) with
the default and 297 s (1295 s summed) with this module's one thread a
worker, every test passing both ways. Every port test module that
imports torch sets the count at its import, so it holds however the
tests are selected; this module does too, and its test checks it.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread_per_test_process():
    assert torch.get_num_threads() == 1
