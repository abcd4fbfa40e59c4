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
    return [re.search(r"(\w+)\(", re.sub(r"__launch_bounds__\([^)]*\)",
                                         "", c)).group(1) for c in chunks]


@pytest.mark.parametrize("argv,mode", [
    ([], (False, False, False)), (["--conv-forward"], (True, False, False)),
    (["--conv-backward"], (False, True, False)),
    (["--part-dist"], (False, False, True))])
def test_modes_parse(argv, mode):
    args = CS.parse_args(argv)
    assert (args.conv_forward, args.conv_backward, args.part_dist) == mode


@pytest.mark.parametrize("argv", [["--conv-forward", "--conv-backward"],
                                  ["--part-dist", "--conv-forward"],
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


def test_profile_groups_split_the_two_part_dist_kernels():
    """Every kernel of csrc/part_dist.cu falls in `part_dist` alone, and
    every kernel of csrc/part_dist_v1.cu in `part_dist_v1` alone."""
    new = _kernels("part_dist.cu")
    old = _kernels("part_dist_v1.cu")
    assert sorted(new) == ["part_dist_rows_finish_kernel",
                           "part_dist_rows_kernel"]
    assert sorted(old) == ["part_dist_v1_finish_kernel",
                           "part_dist_v1_kernel"]
    groups = CS.PROFILE_GROUPS
    for name, family in [(n, "part_dist") for n in new] + \
            [(n, "part_dist_v1") for n in old]:
        label = f"void (anonymous namespace)::{name}<1>(float const*)"
        assert [g for g, key in groups.items() if key in label] == [family]


def test_profile_groups_split_the_two_csr_kernels():
    """Every kernel of csrc/csr_reduce.cu falls in `csr_reduce` alone, and
    every kernel of csrc/csr_reduce_v1.cu in `csr_reduce_v1` alone, so the
    step's profile tells the two apart when v1 is swapped in."""
    new = _kernels("csr_reduce.cu")
    old = _kernels("csr_reduce_v1.cu")
    assert sorted(new) == ["csr_rows_finish_kernel", "csr_rows_kernel",
                           "csr_rows_long_kernel"]
    assert sorted(old) == ["csr_v1_long_finish_kernel",
                           "csr_v1_long_partial_kernel",
                           "csr_v1_short_kernel"]
    groups = CS.PROFILE_GROUPS
    for name, family in [(n, "csr_reduce") for n in new] + \
            [(n, "csr_reduce_v1") for n in old]:
        label = f"void (anonymous namespace)::{name}<4, 4, true>(float4)"
        assert [g for g, key in groups.items() if key in label] == [family]


def test_csr_reduce_mode_parses():
    args = CS.parse_args(["--csr-reduce"])
    assert args.csr_reduce and not (args.conv_forward or args.conv_backward
                                    or args.part_dist or args.gather_rows)
    assert not CS.parse_args([]).csr_reduce
    with pytest.raises(SystemExit):
        CS.parse_args(["--csr-reduce", "--gather-rows"])


def test_launch_literals():
    """The conv forward's count per path is the new kernel's; v1 is
    counted and expected at 0 everywhere; the Trainer's default step at
    batch 12 is the take route (both gates closed): 9 conv forwards and
    dW, every dx half of the 8 convs with one unfused (a csr_reduce
    each), and every row gather with a gradient adds one csr_reduce (its
    backward); the forced banded arm keeps the counts of the JAX gates:
    4 take-route convs, 4 unfused dx and 7 fix-up backwards."""
    assert "spiral_conv_fwd_v1" in CS.KERNEL_COUNTS
    assert [CS.SERVE_LAUNCHES[r]["spiral_conv_fwd"]
            for r in ("small", "large", "take")] == [4, 9, 9]
    assert CS.STEP_LAUNCHES["spiral_conv_fwd"] == 9
    assert CS.TRAIN_LAUNCHES["spiral_conv_fwd"] == 9
    assert CS.TRAIN_LAUNCHES["spiral_conv_bwd_dx"] == 0
    assert CS.TRAIN_LAUNCHES["csr_reduce"] == 8 + (
        CS.ENCODE_GATHER_GRADS + CS.UNPOOL_GATHERS
        + CS.LOSS_GATHER_GRADS) == 24
    assert CS.expect(CS.TRAIN_LAUNCHES)["banded_gather_fwd"] == 0
    assert CS.expect(CS.VAL_LAUNCHES)["banded_gather_fwd"] == 0
    assert CS.TRAIN_LAUNCHES_BANDED["spiral_conv_fwd"] == 4
    assert CS.TRAIN_LAUNCHES_BANDED["csr_reduce"] == 7 + 4 + (
        CS.ENCODE_GATHER_GRADS + CS.LOSS_GATHER_GRADS) == 23
    assert CS.STEP_LAUNCHES["csr_reduce"] == 17
    assert set(CS.YARDSTICKS) == {"spiral_conv_fwd_v1", "part_dist_v1",
                                  "csr_reduce_v1"}
    assert set(CS.YARDSTICKS) <= set(CS.KERNEL_COUNTS)
    assert CS.STEP_LAUNCHES["part_dist_fwd_grad"] == 2
    assert CS.TRAIN_LAUNCHES["part_dist_fwd_grad"] == 2
    for table in (CS.STEP_LAUNCHES, CS.TRAIN_LAUNCHES,
                  CS.TRAIN_LAUNCHES_BANDED, *CS.SERVE_LAUNCHES.values()):
        for k in CS.YARDSTICKS:
            assert CS.expect(table)[k] == 0


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


def test_trainer_mode_parses():
    args = CS.parse_args(["--trainer"])
    assert args.trainer and not (args.conv_forward or args.csr_reduce)
    assert not CS.parse_args([]).trainer
    with pytest.raises(SystemExit):
        CS.parse_args(["--trainer", "--part-dist"])


def test_graph_launch_literals():
    """The epoch path's captured step is the 'dynamic' exchange variant:
    the volume term (one face gather and its backward) runs on every step,
    so it launches what a loop step that drew 'ori' does, the 'm' draw's
    fewer launches never apply, and the yardsticks stay at 0."""
    assert CS.GRAPH_LAUNCHES == CS.TRAIN_LAUNCHES
    assert CS.GRAPH_LAUNCHES_BANDED == CS.TRAIN_LAUNCHES_BANDED
    assert CS.GRAPH_LAUNCHES["row_gather"] == 6 + 4 + 11
    assert CS.GRAPH_LAUNCHES["csr_reduce"] == 24
    assert CS.GRAPH_LAUNCHES_BANDED["row_gather"] == 6 + 8 + 11
    assert CS.GRAPH_LAUNCHES_BANDED["csr_reduce"] == 23
    assert set(CS.M_VARIANT_FEWER) <= set(CS.GRAPH_LAUNCHES)
    for k in CS.YARDSTICKS:
        assert CS.expect(CS.GRAPH_LAUNCHES)[k] == 0


@pytest.mark.parametrize("flag,attr", [("--dfaust", "dfaust"),
                                       ("--band-gates", "band_gates")])
def test_dfaust_and_gate_modes_parse(flag, attr):
    args = CS.parse_args([flag])
    assert getattr(args, attr) and not (args.trainer or args.conv_forward)
    assert not getattr(CS.parse_args([]), attr)
    with pytest.raises(SystemExit):
        CS.parse_args([flag, "--trainer"])


def test_forced_gates_are_the_jax_gates_and_the_port_closed_both():
    """The forced banded arms open the gates the JAX package sets; the
    port's own gates are closed (the card's measurements)."""
    from semantichuman_torch.ops import sampling as TS
    from semantichuman_tpu.ops import sampling as JS
    import importlib
    tc = importlib.import_module("semantichuman_torch.ops.spiral_conv")
    jc = importlib.import_module("semantichuman_tpu.ops.spiral_conv")
    assert CS.FORCED_GATES == (jc._BANDED_MAX_B, JS._UNPOOL_BAND_MAX_B)
    assert (tc._BANDED_MAX_B, TS._UNPOOL_BAND_MAX_B) == (0, 0)
    with CS.band_gates(*CS.FORCED_GATES):
        assert (tc._BANDED_MAX_B, TS._UNPOOL_BAND_MAX_B) == (16, 128)
    assert (tc._BANDED_MAX_B, TS._UNPOOL_BAND_MAX_B) == (0, 0)


@pytest.mark.parametrize("stacked", [True, False])
def test_dfaust_config_overrides_only_the_dataset(tmp_path, stacked):
    """Phase 8's config is configs/train_dfaust.yaml with root_dir,
    asset_dir and n_val set (and from_stacked off for the per-sample
    layout): the bf16 trunk, banded_conv off and every other field as
    the file has them."""
    from semantichuman_torch.config import Config
    path = CS.dfaust_config(tmp_path / "DF", tmp_path / "c.yaml", stacked)
    got = Config.from_yaml(path).to_dict()
    want = Config.from_yaml(str(CS.DFAUST_CONFIG)).to_dict()
    want["data"].update(root_dir=str(tmp_path / "DF"),
                        asset_dir=str(tmp_path / "DF" / "asset"),
                        n_val=CS.DFAUST_VAL, from_stacked=stacked)
    assert got == want
    assert got["model"]["trunk_dtype"] == "bfloat16"
    assert got["model"]["banded_conv"] is False
