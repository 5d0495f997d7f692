"""The plain reference of the benchmark's comparisons.

A frozen copy of the port's plain versions (``handle_actions_plain``, the
plain observation, the plain threefry2x32 draws, the Empty and
BlockedUnlockPickup layouts, the reserve pool), patched so that every call
takes its plain PyTorch form on any device, and a plain vector env over
them (:mod:`.vector`). It imports nothing of ``multigrid_tpu_torch``: what
the program computes is judged against what this package computes from
the same keys. The docstrings are the port's, as copied.
"""
