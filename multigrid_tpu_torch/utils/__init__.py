"""Small helpers shared by the port: indexed enums and device resolution."""

from .device import resolve_device

__all__ = ['resolve_device']
