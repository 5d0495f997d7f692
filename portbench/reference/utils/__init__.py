"""Devices, enums and keyed draws."""
