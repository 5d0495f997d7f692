"""Batched lockstep execution on one device."""

from .vector import VectorEnv

__all__ = ['VectorEnv']
