"""PartAE (the paper's multiz+partkps flagship) with explicit parameter
dicts, its device tables and the spiral-conv trunk."""

from .factory import build_model  # noqa: F401
from .part_ae import PartAE  # noqa: F401
from .tables import DeviceTables, device_tables  # noqa: F401
