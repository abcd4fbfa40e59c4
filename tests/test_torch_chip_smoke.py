"""chip_smoke.py's pieces that need no card: its modes, the kernel families
its step profile reports, the launch literals of the main paths, and the
batches at which phase 2 checks the conv forward."""

import re
from pathlib import Path

import pytest

import chip_smoke as CS

CSRC = Path(__file__).resolve().parents[1] / "semantichuman_torch" / "csrc"


def _kernels(source):
    """The __global__ functions of a CUDA source, by name."""
    chunks = (CSRC / source).read_text().split("__global__")[1:]
    return [re.search(r"\n(\w+)\(", c).group(1) for c in chunks]


@pytest.mark.parametrize("argv,mode", [
    ([], (False, False)), (["--conv-forward"], (True, False)),
    (["--conv-backward"], (False, True))])
def test_modes_parse(argv, mode):
    args = CS.parse_args(argv)
    assert (args.conv_forward, args.conv_backward) == mode


@pytest.mark.parametrize("argv", [["--conv-forward", "--conv-backward"],
                                  ["--conv"], ["extra"]])
def test_modes_refuse_the_rest(argv):
    with pytest.raises(SystemExit):
        CS.parse_args(argv)


def test_profile_groups_split_the_two_forward_kernels():
    """Every kernel of csrc/spiral_conv_fwd.cu falls in `conv_fwd` and in
    no other family; the v1 kernel of csrc/spiral_conv.cu in
    `conv_fwd_v1` alone, so the step's profile shows v1 at 0 ms."""
    new = _kernels("spiral_conv_fwd.cu")
    old = _kernels("spiral_conv.cu")
    assert sorted(new) == ["sc_fwd_narrow_kernel", "sc_fwd_tile_kernel"]
    assert old == ["spiral_conv_fwd_kernel"]
    groups = CS.PROFILE_GROUPS
    for name, family in [(n, "conv_fwd") for n in new] + \
            [(n, "conv_fwd_v1") for n in old]:
        label = f"void (anonymous namespace)::{name}<float, 128>(float)"
        assert [g for g, key in groups.items() if key in label] == [family]


def test_launch_literals():
    """The conv forward's count per path is the new kernel's; v1 is
    counted and expected at 0 everywhere; at the Trainer's batch 12 every
    dx half of the four take-route convs goes unfused (4 csr_reduce more
    than the 7 fix-up backwards)."""
    assert "spiral_conv_fwd_v1" in CS.KERNEL_COUNTS
    assert [CS.SERVE_LAUNCHES[r]["spiral_conv_fwd"]
            for r in ("small", "large", "take")] == [4, 9, 9]
    assert CS.STEP_LAUNCHES["spiral_conv_fwd"] == 9
    assert CS.TRAIN_LAUNCHES["spiral_conv_fwd"] == 4
    assert CS.TRAIN_LAUNCHES["spiral_conv_bwd_dx"] == 0
    assert CS.TRAIN_LAUNCHES["csr_reduce"] == 7 + 4
    for table in (CS.STEP_LAUNCHES, CS.TRAIN_LAUNCHES,
                  *CS.SERVE_LAUNCHES.values()):
        assert CS.expect(table)["spiral_conv_fwd_v1"] == 0


def _trainer_batches():
    """The Trainer's trunk batch and its validation batch (one batch of
    every test mesh)."""
    return (CS.TRAINER_TRUNK_B, CS.trainer_cfg().data.synthetic_test)


@pytest.mark.parametrize("path,batches", [
    ("serving", lambda: CS.SERVE_BATCHES), ("step", lambda: (CS.TRUNK_B,)),
    ("trainer", _trainer_batches)])
def test_forward_phase_covers_the_main_paths(path, batches):
    """Phase 2 holds the forward kernel against its plain version at every
    batch at which a main path runs it."""
    assert set(batches()) <= set(CS.FWD_BATCHES), path
    assert set(CS.FWD_TIMED) <= set(CS.FWD_BATCHES)
