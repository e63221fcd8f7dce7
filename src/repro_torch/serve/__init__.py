"""Batched greedy serving of the port."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
