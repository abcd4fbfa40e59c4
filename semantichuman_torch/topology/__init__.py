"""Mesh hierarchy tables, loaded from a compiled .npz."""

from .hierarchy import MeshHierarchy  # noqa: F401
