"""Helpers of the port: indexed enums, device resolution, the kernels' build,
checkpoints, profiling, rendering primitives, pretty-printing and MiniGrid
compatibility."""

from .device import resolve_device

__all__ = ['resolve_device']
