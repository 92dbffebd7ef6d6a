"""``paddle.save`` / ``paddle.load`` of the port against the reference's
(``paddle_tpu/framework/io.py``), in both directions.

The same nested object (fp32, int64 and bf16 tensors, a layer saved as
its flattened ``state_dict``, plain values) is saved by one framework
and loaded by the other, and by itself. Values must be equal exactly:
nothing is computed, only copied. On disk a bf16 tensor is a numpy
array of ``ml_dtypes.bfloat16`` in both frameworks' files; the port
reads it without ``ml_dtypes`` as the raw two-byte ``'<V2'`` (its
``return_numpy=True`` view) and gives a bf16 tensor back. ``load``
places tensors on the default place: these tests ``set_device("cpu")``
and the fixture restores the default after each.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as ref

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import place as port_place
from paddle_tpu_torch.nn import Linear

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_place():
    port_place._default_place = None
    paddle.set_device("cpu")
    yield
    port_place._default_place = None


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(3, 4).astype(np.float32),
            rs.randint(-5, 5, (6,)).astype(np.int64),
            rs.randn(2, 5).astype(np.float32).astype(ml_dtypes.bfloat16))


def _port_obj(seed):
    w, ids, h = _arrays(seed)
    layer = Linear(4, 3, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.arange(12, dtype=np.float32)
                                            .reshape(4, 3)))
        layer.bias.fill_(0.5)
    return {"w": torch.from_numpy(w).requires_grad_(),
            "ids": torch.from_numpy(ids),
            "h": torch.from_numpy(h.view(np.int16).copy()).view(
                torch.bfloat16),
            "layer": layer,
            "meta": {"step": 7, "tag": "x", "lr": 0.25,
                     "seq": [1, torch.tensor([2.0, 3.0])],
                     "pair": (4, "y")}}


def _ref_obj(seed):
    w, ids, h = _arrays(seed)
    layer = ref.nn.Linear(4, 3)
    layer.set_state_dict({"weight": np.arange(12, dtype=np.float32)
                          .reshape(4, 3),
                          "bias": np.full((3,), 0.5, np.float32)})
    return {"w": ref.to_tensor(w, stop_gradient=False),
            "ids": ref.to_tensor(ids, dtype="int64"),
            "h": ref.Tensor(jnp.asarray(h)),
            "layer": layer,
            "meta": {"step": 7, "tag": "x", "lr": 0.25,
                     "seq": [1, ref.to_tensor(np.asarray([2.0, 3.0],
                                                         np.float32))],
                     "pair": (4, "y")}}


def _np(x):
    """A loaded value of either framework as numpy (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    arr = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    return arr.astype(np.float32) if arr.dtype == ml_dtypes.bfloat16 \
        else arr


def _check(loaded, seed, bf16_dtype, int_dtype=np.int64):
    """``int_dtype``: JAX without x64 (the reference here) holds int64
    ids as int32, on save and on load alike."""
    w, ids, h = _arrays(seed)
    np.testing.assert_array_equal(_np(loaded["w"]), w)
    np.testing.assert_array_equal(_np(loaded["ids"]), ids)
    assert _np(loaded["ids"]).dtype == int_dtype
    np.testing.assert_array_equal(_np(loaded["h"]), h.astype(np.float32))
    assert bf16_dtype(loaded["h"])
    np.testing.assert_array_equal(
        _np(loaded["layer"]["weight"]),
        np.arange(12, dtype=np.float32).reshape(4, 3))
    np.testing.assert_array_equal(_np(loaded["layer"]["bias"]),
                                  np.full((3,), 0.5, np.float32))
    meta = loaded["meta"]
    assert (meta["step"], meta["tag"], meta["lr"], meta["pair"]) == \
        (7, "x", 0.25, (4, "y"))
    assert meta["seq"][0] == 1
    np.testing.assert_array_equal(_np(meta["seq"][1]), [2.0, 3.0])


def test_port_to_reference(tmp_path):
    path = str(tmp_path / "port.pdparams")
    paddle.save(_port_obj(1), path)
    loaded = ref.load(path)
    _check(loaded, 1, lambda t: t.numpy().dtype == ml_dtypes.bfloat16,
           np.int32)
    assert isinstance(loaded["w"], ref.Tensor)
    assert loaded["w"].stop_gradient is False
    assert loaded["ids"].stop_gradient is True


def test_reference_to_port(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    ref.save(_ref_obj(2), path)
    loaded = paddle.load(path)
    _check(loaded, 2, lambda t: t.dtype == torch.bfloat16, np.int32)
    assert isinstance(loaded["w"], torch.Tensor)
    assert loaded["w"].requires_grad and not loaded["ids"].requires_grad
    assert loaded["w"].device.type == "cpu"


def test_port_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "port.pdparams")
    paddle.save(_port_obj(3), path)
    _check(paddle.load(path), 3, lambda t: t.dtype == torch.bfloat16)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_return_numpy(tmp_path, writer):
    """``return_numpy=True`` gives numpy arrays: the reference's bf16 as
    ml_dtypes' bfloat16, the port's as the same bits in ``'<V2'``."""
    path = str(tmp_path / "x.pdparams")
    if writer == "port":
        paddle.save(_port_obj(4), path)
    else:
        ref.save(_ref_obj(4), path)
    w, ids, h = _arrays(4)
    mine = paddle.load(path, return_numpy=True)
    theirs = ref.load(path, return_numpy=True)
    for got in (mine, theirs):
        np.testing.assert_array_equal(got["w"], w)
        np.testing.assert_array_equal(got["ids"], ids)
        np.testing.assert_array_equal(got["layer"]["bias"],
                                      np.full((3,), 0.5, np.float32))
    assert mine["h"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(mine["h"].view(np.int16),
                                  h.view(np.int16))
    assert theirs["h"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(theirs["h"].view(np.int16),
                                  h.view(np.int16))


def test_load_imports_neither_jax_nor_the_reference(tmp_path):
    """A reference file read in a process where ``jax``, ``paddle_tpu``
    and ``ml_dtypes`` cannot be imported."""
    path = str(tmp_path / "ref.pdparams")
    ref.save(_ref_obj(5), path)
    code = (
        "import sys\n"
        "for m in ('jax', 'paddle_tpu', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "import paddle_tpu_torch as paddle\n"
        "paddle.set_device('cpu')\n"
        f"x = paddle.load({path!r})\n"
        "assert x['h'].dtype == torch.bfloat16, x['h'].dtype\n"
        "assert x['layer']['weight'].shape == (4, 3)\n"
        "paddle.save(x, sys.argv[1])\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "back.pdparams")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    _check(ref.load(str(tmp_path / "back.pdparams")), 5,
           lambda t: t.numpy().dtype == ml_dtypes.bfloat16, np.int32)
