"""The port's top-level namespace against the reference's.

``import paddle_tpu_torch as paddle`` must give every public name that
``import paddle_tpu`` gives (402, counted in a fresh process), or the
name must be in ``ABSENT_TOP`` of ``tests/test_torch_signatures.py``
with its reason and its ROADMAP Queue 1 item; no entry there may name
something the port has. The subpackages resolve on a fresh import
(``paddle_tpu_torch.nn`` without importing it first), and
``paddle_tpu_torch.grad`` gives the reference's gradients on one small
function, a second derivative through ``create_graph=True`` included
(fp32 on both sides: atol 1e-5, rtol 1e-6).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as ref

import paddle_tpu_torch as paddle
from test_torch_signatures import ABSENT_TOP

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-6)


def _fresh(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def reference_names():
    """The public names of ``paddle_tpu`` right after ``import
    paddle_tpu`` in a fresh process (a test process's other imports would
    add the lazy submodules they touched)."""
    return json.loads(_fresh(
        "import json, paddle_tpu\n"
        "print(json.dumps(sorted(n for n in dir(paddle_tpu)"
        " if not n.startswith('_'))))\n").strip().splitlines()[-1])


def test_every_reference_name_is_in_the_port_or_stated_absent(
        reference_names):
    assert len(reference_names) == 402
    missing = [n for n in reference_names
               if n not in ABSENT_TOP and not hasattr(paddle, n)]
    assert not missing, missing
    stale = [n for n in ABSENT_TOP if hasattr(paddle, n)]
    assert not stale, stale


def test_absent_entries_name_reference_names_with_a_reason(reference_names):
    for name, reason in ABSENT_TOP.items():
        assert name in reference_names, name
        assert "Queue 1 item" in reason or "JAX only" in reason, name


def test_subpackages_resolve_on_a_fresh_import():
    out = _fresh(
        "import torch\n"
        "import paddle_tpu_torch as paddle\n"
        "assert 'paddle_tpu_torch.optimizer' not in __import__('sys')"
        ".modules\n"
        "assert paddle.nn.Linear.__module__.startswith('paddle_tpu_torch')\n"
        "assert paddle.optimizer.AdamW is not None\n"
        "assert paddle.float32 is torch.float32\n"
        "assert paddle.models.gpt3_1p3b().num_heads == 16\n"
        "assert paddle.framework.save is paddle.framework.io.save\n"
        "assert paddle.device.cuda.memory_allocated() == 0\n"
        "assert paddle.ParamAttr is paddle.nn.ParamAttr\n"
        "assert 'jax' not in __import__('sys').modules\n"
        "print('ok')\n")
    assert out.strip().splitlines()[-1] == "ok"


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no attribute 'vision'"):
        paddle.vision


def _fn_inputs():
    rs = np.random.RandomState(3)
    return rs.randn(5).astype(np.float32), rs.randn(5).astype(np.float32)


def test_grad_matches_the_reference():
    xv, wv = _fn_inputs()
    x = torch.tensor(xv, requires_grad=True)
    w = torch.tensor(wv, requires_grad=True)
    y = (w * x * x * x).sum()
    gx, gw = paddle.grad(y, [x, w])
    rx = ref.to_tensor(xv, stop_gradient=False)
    rw = ref.to_tensor(wv, stop_gradient=False)
    ry = (rw * rx * rx * rx).sum()
    rgx, rgw = ref.grad(ry, [rx, rw])
    np.testing.assert_allclose(gx.numpy(), rgx.numpy(), **TOL)
    np.testing.assert_allclose(gw.numpy(), rgw.numpy(), **TOL)
    assert x.grad is None and w.grad is None


def test_grad_create_graph_matches_the_reference():
    """d/dx sum(d y / dx) through ``create_graph=True``: 6 w x."""
    xv, wv = _fn_inputs()
    x = torch.tensor(xv, requires_grad=True)
    w = torch.tensor(wv)
    (g,) = paddle.grad((w * x * x * x).sum(), x, create_graph=True)
    (gg,) = paddle.grad(g.sum(), x)
    rx = ref.to_tensor(xv, stop_gradient=False)
    rw = ref.to_tensor(wv)
    (rg,) = ref.grad((rw * rx * rx * rx).sum(), rx, create_graph=True)
    (rgg,) = ref.grad(rg.sum(), rx)
    np.testing.assert_allclose(g.detach().numpy(), rg.numpy(), **TOL)
    np.testing.assert_allclose(gg.numpy(), rgg.numpy(), **TOL)
    np.testing.assert_allclose(gg.numpy(), 6 * wv * xv, **TOL)


def test_grad_unused_input():
    x = torch.tensor([1.0], requires_grad=True)
    z = torch.tensor([2.0], requires_grad=True)
    with pytest.raises(RuntimeError):
        paddle.grad((x * 2).sum(), [x, z])
    gx, gz = paddle.grad((x * 2).sum(), [x, z], allow_unused=True)
    assert gz is None and float(gx) == 2.0


def test_tensor_api_is_torch_s():
    assert paddle.Tensor is torch.Tensor
    assert paddle.Parameter is torch.nn.Parameter
    with paddle.no_grad():
        assert not paddle.is_grad_enabled() and not paddle.is_grad_enabled_()
        with paddle.enable_grad():
            assert paddle.is_grad_enabled()
