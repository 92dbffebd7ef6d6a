"""Places and device resolution for the PyTorch port.

Counterpart of ``paddle_tpu/core/place.py``: the tagged device identity
``Place`` (platform, device_id), its constructors, and the process's
default place (``set_device``, ``get_device``, ``get_default_place``).
A place resolves to a ``torch.device`` (``Place.torch_device``), not a
``jax.Device``; the platforms are ``"gpu"`` (torch's ``"cuda"``) and
``"cpu"``.

The port's entry points run on the card unless the caller asks for the
CPU: the default place is ``gpu:0`` whether or not the host has a card
(the reference probes its backend and falls back to the CPU; the port
never does), and ``resolve_device()`` with no argument gives the default
place's device, raising a clear error on a host without a card. A
caller that wants the CPU passes ``device="cpu"``, or opts in for the
process with ``set_device("cpu")``.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

__all__ = [
    "Place",
    "CPUPlace",
    "TPUPlace",
    "GPUPlace",
    "CustomPlace",
    "CUDAPlace",
    "CUDAPinnedPlace",
    "NPUPlace",
    "set_device",
    "get_device",
    "get_default_place",
    "device_count",
    "is_compiled_with_tpu",
    "resolve_device",
    "module_device",
]

_TORCH_TYPE = {"gpu": "cuda", "cpu": "cpu"}


class Place:
    """Tagged device identity: (platform, device_id)."""

    __slots__ = ("platform", "device_id")

    def __init__(self, platform: str, device_id: int = 0):
        self.platform = platform
        self.device_id = int(device_id)

    # -- identity ----------------------------------------------------------
    def __eq__(self, other):
        return (
            isinstance(other, Place)
            and self.platform == other.platform
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self.platform, self.device_id))

    def __repr__(self):
        return f"Place({self.platform}:{self.device_id})"

    # -- resolution --------------------------------------------------------
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this place: ``gpu:i`` is ``cuda:i``,
        ``cpu`` the CPU. A platform the port has no device for (``tpu``,
        a custom one) raises ``ValueError``; ``gpu`` on a host without a
        card raises ``RuntimeError``."""
        kind = _TORCH_TYPE.get(self.platform)
        if kind is None:
            raise ValueError(f"{self}: the port runs on 'gpu' (CUDA) or "
                             "'cpu' places only")
        if kind == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self} was requested but no CUDA device is available on "
                "this host; pass device='cpu' or call set_device('cpu') to "
                "run the plain PyTorch versions on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise ValueError(f"{self} out of range: the host has "
                             f"{torch.cuda.device_count()} card(s)")
        return torch.device("cuda", self.device_id)

    def is_cpu_place(self) -> bool:
        return self.platform == "cpu"

    def is_tpu_place(self) -> bool:
        return self.platform == "tpu"

    def is_gpu_place(self) -> bool:
        return self.platform == "gpu"


def CPUPlace() -> Place:
    return Place("cpu", 0)


def TPUPlace(device_id: int = 0) -> Place:
    """The reference's accelerator place; the port has no TPU, so it
    resolves to nothing (``Place.torch_device`` raises)."""
    return Place("tpu", device_id)


def GPUPlace(device_id: int = 0) -> Place:
    return Place("gpu", device_id)


def CustomPlace(platform: str, device_id: int = 0) -> Place:
    """The reference's pluggable-device place: any platform string."""
    return Place(platform, device_id)


def CUDAPlace(device_id: int = 0) -> Place:
    """The CUDA card ``device_id``: ``gpu:device_id``."""
    return Place("gpu", device_id)


def CUDAPinnedPlace() -> Place:
    """Pinned-host staging place: host memory, a CPU place as in the
    reference."""
    return Place("cpu", 0)


def NPUPlace(device_id: int = 0) -> Place:
    """An accelerator alias, as in the reference: the card here."""
    return Place("gpu", device_id)


_default_place_lock = threading.Lock()
_default_place: Optional[Place] = None


def get_default_place() -> Place:
    """The process's default place: ``gpu:0`` until :func:`set_device`
    names another, on a host without a card too."""
    global _default_place
    with _default_place_lock:
        if _default_place is None:
            _default_place = Place("gpu", 0)
        return _default_place


def set_device(device: str) -> Place:
    """``set_device("gpu")`` / ``set_device("gpu:1")`` /
    ``set_device("cpu")``: the default place of every entry point called
    without a device. Validated eagerly, as the reference does:
    ``"gpu"`` on a host without a card raises and leaves the default as
    it was."""
    global _default_place
    if ":" in device:
        platform, _, idx = device.partition(":")
        place = Place(platform, int(idx))
    else:
        place = Place(device, 0)
    place.torch_device()  # validate eagerly
    with _default_place_lock:
        _default_place = place
    return place


def get_device() -> str:
    p = get_default_place()
    return f"{p.platform}:{p.device_id}"


def device_count(platform: Optional[str] = None) -> int:
    """Cards of the host (``platform`` None or ``"gpu"``), 1 for
    ``"cpu"``, 0 for a platform the port has no device for."""
    if platform in (None, "gpu"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1 if platform == "cpu" else 0


def is_compiled_with_tpu() -> bool:
    """False: the port runs on CUDA cards."""
    return False


def resolve_device(device: Optional[Union[str, torch.device, Place]] = None
                   ) -> torch.device:
    """Turn ``device`` (default: the default place, ``gpu:0`` unless
    :func:`set_device` named another) into a ``torch.device``.

    A CUDA device on a host where ``torch.cuda.is_available()`` is false
    raises ``RuntimeError`` naming the explicit ``device="cpu"`` opt-in,
    rather than silently running somewhere else."""
    if device is None:
        device = get_default_place()
    if isinstance(device, Place):
        if device.platform not in _TORCH_TYPE:
            return device.torch_device()    # raises, naming the place
        device = ("cpu" if device.platform == "cpu"
                  else torch.device("cuda", device.device_id))
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but no CUDA device "
            "is available on this host; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device a module's parameters live on (they must agree)."""
    devs = {p.device for p in module.parameters()}
    if len(devs) != 1:
        raise ValueError(f"module parameters span devices {sorted(map(str, devs))}")
    return devs.pop()
