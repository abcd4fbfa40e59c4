"""The models with explicit parameter dicts: PartAE (the paper's
multiz+partkps) and SpiralAE (the neural3DMM baseline), their device
tables and the spiral-conv trunk."""

from .factory import build_model  # noqa: F401
from .part_ae import PartAE  # noqa: F401
from .spiral_ae import SpiralAE  # noqa: F401
from .tables import DeviceTables, device_tables  # noqa: F401
