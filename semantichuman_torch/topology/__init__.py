"""Host-side topology compiler (NumPy, with the repo's C++ AABB tree for
the nearest-point queries): the QEM mesh hierarchy, the spiral orderings
per level and the pool/unpool tables, as one `MeshHierarchy` cached as a
`.npz`."""

from .compiler import compile_topology  # noqa: F401
from .hierarchy import MeshHierarchy  # noqa: F401
