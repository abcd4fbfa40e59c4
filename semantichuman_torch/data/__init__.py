"""Synthetic SMPL-shaped human assets."""

from .synthetic import SyntheticHuman  # noqa: F401
