"""Distributed launcher (reference python/paddle/distributed/launch)."""

from .main import launch, main  # noqa: F401

__all__ = ["launch", "main"]
