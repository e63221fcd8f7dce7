"""Continuous batching serving of the port."""
from .engine import PromptTooLong, Request, ServeEngine

__all__ = ["PromptTooLong", "Request", "ServeEngine"]
