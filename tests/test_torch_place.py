"""The port's places (``paddle_tpu_torch/core/place.py``) against the
reference's (``paddle_tpu/core/place.py``).

A ``Place`` of the port is the reference's tagged identity (platform,
device_id) with the same equality, hash and repr; it resolves to a
``torch.device``. The default place is ``gpu:0`` on a host without a
card too (the reference probes its backend and falls back to the CPU;
the port never does), ``set_device("gpu")`` raises here as the
reference's eager validation does, and ``set_device("cpu")`` is the
process's opt-in: entry points called without a device then build on
the CPU. The fixture restores the default after every test, so no other
test of an xdist worker sees a place set here.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.core import place as ref_place

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import place as port_place

# one torch intra-op thread a test process (test_torch_cpu_threads.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def default_place():
    """Every test starts from the unset default and leaves it unset."""
    port_place._default_place = None
    yield
    port_place._default_place = None


PLACES = [("cpu", 0), ("gpu", 0), ("gpu", 3), ("tpu", 1), ("npu", 2)]


@pytest.mark.parametrize("platform,idx", PLACES)
def test_place_identity_matches_the_reference(platform, idx):
    mine = port_place.Place(platform, idx)
    theirs = ref_place.Place(platform, idx)
    assert repr(mine) == repr(theirs)
    assert hash(mine) == hash(theirs)
    assert mine == port_place.Place(platform, idx)
    assert mine != port_place.Place(platform, idx + 1)
    assert mine != port_place.Place("other", idx)
    assert (mine.is_cpu_place(), mine.is_gpu_place(), mine.is_tpu_place()) \
        == (theirs.is_cpu_place(), theirs.is_gpu_place(),
            theirs.is_tpu_place())
    assert len({mine, port_place.Place(platform, idx)}) == 1


@pytest.mark.parametrize("ctor,args", [("CPUPlace", ()), ("TPUPlace", (2,)),
                                       ("GPUPlace", (1,)),
                                       ("CustomPlace", ("npu", 3)),
                                       ("CUDAPinnedPlace", ())])
def test_constructors_match_the_reference(ctor, args):
    """The constructors that do not probe a backend give the reference's
    places; CUDAPlace and NPUPlace name the card (the reference maps them
    to its accelerator, the CPU backend on this host)."""
    assert repr(getattr(port_place, ctor)(*args)) == \
        repr(getattr(ref_place, ctor)(*args))


def test_cuda_and_npu_places_are_the_card():
    assert port_place.CUDAPlace(1) == port_place.Place("gpu", 1)
    assert port_place.NPUPlace() == port_place.Place("gpu", 0)


def test_default_place_is_the_card_without_one():
    assert not torch.cuda.is_available()
    assert paddle.get_device() == "gpu:0"
    assert port_place.get_default_place() == port_place.GPUPlace(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_place.resolve_device()


def test_set_device_gpu_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.set_device("gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle.set_device("gpu:1")
    assert paddle.get_device() == "gpu:0"
    with pytest.raises(ValueError, match="'gpu'"):
        paddle.set_device("tpu")


def test_set_device_cpu_is_the_entry_points_default():
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    place = paddle.set_device("cpu")
    assert place == port_place.CPUPlace()
    assert paddle.get_device() == "cpu:0"
    assert port_place.resolve_device() == torch.device("cpu")
    model = GPTForCausalLM(gpt_tiny(), seed=0)
    assert port_place.module_device(model).type == "cpu"
    assert paddle.to_tensor([1.0, 2.0]).device.type == "cpu"
    assert paddle.zeros([2, 3]).device.type == "cpu"
    # an explicit device still wins
    assert port_place.resolve_device("cpu") == torch.device("cpu")


def test_places_resolve_to_torch_devices():
    assert port_place.CPUPlace().torch_device() == torch.device("cpu")
    assert port_place.resolve_device(port_place.CPUPlace()) == \
        torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_place.GPUPlace(0).torch_device()
    with pytest.raises(ValueError, match="'gpu'"):
        port_place.resolve_device(port_place.TPUPlace())


def test_counts_and_tpu():
    assert paddle.is_compiled_with_tpu() is False
    assert paddle.device_count() == 0
    assert paddle.device_count("gpu") == 0
    assert paddle.device_count("cpu") == 1
    assert paddle.device.cuda.device_count() == 0


def test_memory_counters_read_zero_without_a_card():
    from paddle_tpu_torch.device import cuda

    assert cuda.memory_allocated() == cuda.max_memory_allocated() == 0
    assert cuda.memory_reserved() == cuda.max_memory_reserved() == 0
    assert paddle.memory.memory_stats() == {}
    cuda.empty_cache()
    paddle.device.synchronize()
    cuda.synchronize()


def _public(path):
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                and not n.name.startswith("_"):
            out.add(n.name)
            if isinstance(n, ast.ClassDef):
                out |= {f"{n.name}.{f.name}" for f in n.body
                        if isinstance(f, ast.FunctionDef)
                        and not f.name.startswith("_")}
    return out


def test_every_reference_callable_has_a_counterpart():
    """core/place.py has every public callable of the reference's, but
    ``Place.jax_device`` (a jax.Device), whose counterpart is
    ``Place.torch_device``."""
    ref = _public(ROOT / "paddle_tpu/core/place.py")
    mine = _public(ROOT / "paddle_tpu_torch/core/place.py")
    assert ref - mine == {"Place.jax_device"}
    assert mine - ref == {"Place.torch_device", "resolve_device",
                          "module_device"}


def test_dtypes_are_torch_dtypes():
    from paddle_tpu_torch.core import dtype as D

    assert paddle.float32 is torch.float32 and paddle.bool is torch.bool
    assert D.dtype("bf16") is torch.bfloat16
    assert D.dtype(np.float16) is torch.float16
    assert D.dtype(np.dtype("int64")) is torch.int64
    assert D.dtype(torch.int8) is torch.int8
    assert D.is_floating("bfloat16") and not D.is_floating("int32")
    assert D.is_integer("uint8") and not D.is_integer("bool")
    assert D.is_complex("complex64") and not D.is_complex("float64")
    assert D.default_float_dtype() is torch.float32
    assert D.promote_types("int32", "float16") is torch.float16
    with pytest.raises(ValueError, match="unknown dtype"):
        D.dtype("float8")
