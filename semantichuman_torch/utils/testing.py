"""Test helpers that force the banded routes on (the port's counterpart of
`semantichuman_tpu/utils/testing.py`).

The banded routes of `spiral_conv` and `unpool` engage only on the card,
and the band tables only at full-size levels.  These patches shrink the
band presets and table floors to a small test topology and open both batch
gates, so that a CPU run exercises the banded routes through the kernels'
plain versions.
"""

from __future__ import annotations

_SMALL_PRESETS = ((8, 32), (16, 64))


def band_gate_patches():
    """The patch set as (module, attribute, forced value) triples, for
    `force_band_gates` and pytest's `monkeypatch.setattr` alike."""
    import importlib

    from ..models import tables as tables_mod
    from ..ops import banding as banding_mod
    from ..ops import sampling as sampling_mod

    sconv_mod = importlib.import_module(
        "semantichuman_torch.ops.spiral_conv")
    return [
        (tables_mod, "BAND_MIN_V1", 1),
        (tables_mod, "BAND_MIN_ROWS", 1),
        (banding_mod, "BAND_PRESETS", _SMALL_PRESETS),
        (banding_mod, "UNPOOL_BAND_PRESETS", _SMALL_PRESETS),
        (banding_mod, "MAX_OOB_FRAC", 1.0),
        (sconv_mod, "_banded_ok", lambda *a: True),
        (sampling_mod, "_unpool_band_ok", lambda *a: True),
    ]


def force_band_gates():
    """Apply band_gate_patches; returns a callable that restores them."""
    patches = band_gate_patches()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, val in patches:
        setattr(mod, name, val)

    def restore():
        for mod, name, val in saved:
            setattr(mod, name, val)

    return restore
