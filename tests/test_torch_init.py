"""Fresh weights of the port's layers follow the reference's
initializers.

``nn.Linear``, ``ColumnParallelLinear`` and ``RowParallelLinear`` draw
XavierUniform over the (in, out) layout and ``VocabParallelEmbedding``
over (vocab, hidden): U(-a, a), a = sqrt(6 / (fan_in + fan_out))
(``paddle_tpu/nn/layers/common.py:39``,
``paddle_tpu/distributed/meta_parallel/mp_layers.py:211``);
``nn.Embedding`` draws Normal(0, 1) (``common.py:68``). JAX's threefry
stream is not reproduced, so both packages' freshly built weights are
held to each other by distribution, at several shapes:

- Xavier bounds: every |w| <= a;
- the mean and the variance each within 4 standard errors of the
  distribution's (0 and a^2 / 3, or 0 and 1);
- a two-sample Kolmogorov-Smirnov statistic between the two packages'
  weights under its 1% critical value.

The draws come from torch's default generator, so
``paddle_tpu_torch.seed`` governs them.
"""

import math

import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu.distributed import meta_parallel as jmp
from paddle_tpu.nn import Embedding as JaxEmbedding
from paddle_tpu.nn import Linear as JaxLinear

import paddle_tpu_torch
from paddle_tpu_torch.distributed import meta_parallel as pmp
from paddle_tpu_torch.nn.layers import Embedding, Linear

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

# layer, reference builder, port builder, shapes
LAYERS = {
    "Linear": (JaxLinear, lambda i, o: Linear(i, o, device="cpu")),
    "ColumnParallelLinear": (
        jmp.ColumnParallelLinear,
        lambda i, o: pmp.ColumnParallelLinear(i, o, device="cpu")),
    "RowParallelLinear": (
        jmp.RowParallelLinear,
        lambda i, o: pmp.RowParallelLinear(i, o, device="cpu")),
    "VocabParallelEmbedding": (
        jmp.VocabParallelEmbedding,
        lambda i, o: pmp.VocabParallelEmbedding(i, o, device="cpu")),
    "Embedding": (JaxEmbedding, lambda i, o: Embedding(i, o, device="cpu")),
}
SHAPES = [(64, 48), (300, 20), (17, 257)]


def _weights(layer, shape, seed):
    jax_build, port_build = LAYERS[layer]
    paddle.seed(seed)
    ref = np.asarray(jax_build(*shape).state_dict()["weight"], np.float64)
    paddle_tpu_torch.seed(seed)
    mine = port_build(*shape).weight.detach().numpy().astype(np.float64)
    return ref, mine


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_fresh_weights_follow_the_reference_distribution(layer, shape):
    ref, mine = _weights(layer, shape, seed=3)
    assert ref.shape == mine.shape == shape
    n = mine.size
    if layer == "Embedding":
        var, mu4 = 1.0, 3.0
    else:
        a = math.sqrt(6.0 / (shape[0] + shape[1]))
        for w in (ref, mine):
            assert np.abs(w).max() <= a
        var, mu4 = a * a / 3.0, a ** 4 / 5.0
    # the sample variance's standard error from the fourth moment
    se_var = math.sqrt((mu4 - var * var * (n - 3) / (n - 1)) / n)
    for w in (ref, mine):
        assert abs(w.mean()) < 4 * math.sqrt(var / n)
        assert abs(w.var(ddof=1) - var) < 4 * se_var
    ks = stats.ks_2samp(ref.ravel(), mine.ravel()).statistic
    assert ks < 1.628 * math.sqrt(2.0 / n)     # the 1% critical value


def test_seed_governs_the_draws():
    """The same seed draws the same weights; another seed others. The
    bias starts at zero, as the reference's."""
    a = _weights("Linear", (32, 16), seed=5)[1]
    b = _weights("Linear", (32, 16), seed=5)[1]
    c = _weights("Linear", (32, 16), seed=6)[1]
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    paddle_tpu_torch.seed(0)
    assert torch.count_nonzero(Linear(8, 4, device="cpu").bias) == 0


def test_a_fresh_linear_trains_to_a_finite_loss():
    """The layer that saw an inf loss on the allocator's leftovers: a
    freshly built ``Linear(4, 4)`` gives finite outputs and gradients."""
    paddle_tpu_torch.seed(0)
    lin = Linear(4, 4, device="cpu")
    x = torch.randn(8, 4)
    loss = (lin(x) ** 2).mean()
    loss.backward()
    assert torch.isfinite(loss)
    assert torch.isfinite(lin.weight.grad).all()
