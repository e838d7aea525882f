"""The operations and bytes the metrics count, against hand counts and
independent counts."""

from __future__ import annotations

import torch

from portbench.lib import convwork, lmwork, peaks
from portbench.lib import mamba2_params as MP
from portbench.tests import _tiny


def test_the_stem_pass_by_hand():
    # ResNet-50's 7x7/2 stem at batch 2: 224 -> 112, 3 -> 64 channels.
    g = convwork.square(2, {"H": 224, "C": 3, "N": 64, "K": 7, "S": 2,
                            "P": 3})
    assert (g.H_o, g.W_o) == (112, 112)
    assert convwork.pass_flops(g) == 2 * (2 * 112 * 112 * 64 * 3 * 49)
    assert convwork.pass_bytes(g, 4) == 4 * (2 * 3 * 224 * 224
                                             + 64 * 3 * 49
                                             + 2 * 64 * 112 * 112)


def test_a_projection_shortcut_pass_by_hand():
    # layer3.0.downsample: 1x1/2 at 28 px, 512 -> 1,024 channels.
    g = convwork.square(256, {"H": 28, "C": 512, "N": 1024, "K": 1, "S": 2,
                              "P": 0})
    assert (g.H_o, g.W_o) == (14, 14)
    assert convwork.pass_flops(g) == 2 * 256 * 14 * 14 * 1024 * 512
    assert convwork.pass_bytes(g, 4) == 4 * (256 * 512 * 28 * 28
                                             + 1024 * 512
                                             + 256 * 1024 * 14 * 14)


def test_the_causal_depthwise_conv_by_hand():
    # Mamba2's conv at 8 x 2,048: 2,304 channels of 4 taps.
    g = convwork.causal_depthwise(8, 2048, 2304, 4)
    assert (g.H_o, g.W_o) == (1, 2048)
    assert convwork.pass_flops(g) == 2 * 8 * 2048 * 2304 * 4
    assert convwork.pass_bytes(g, 2) == 2 * (2 * 8 * 2048 * 2304
                                             + 4 * 2304)


def test_a_bound_is_the_larger_of_operations_and_bytes():
    assert peaks.bound_s(495e12, 1.0, "float32") == 1.0
    assert peaks.bound_s(1.0, 3.35e12, "bfloat16") == 1.0
    assert peaks.FLOPS == {"float32": 495e12, "bfloat16": 989e12}


def test_the_roofline_reads_each_span_by_its_dims():
    g = convwork.square(2, {"H": 8, "C": 4, "N": 8, "K": 3, "S": 2, "P": 1})
    dims = {"B": 2, "C": 4, "H_i": 8, "W_i": 8, "N": 8, "K_h": 3, "K_w": 3,
            "s_h": 2, "s_w": 2}
    spans = [{"args": {"dims": dims}}] * 3
    bound = peaks.bound_s(convwork.pass_flops(g),
                          convwork.pass_bytes(g, 4), "float32")
    got = convwork.conv_roofline(spans, {g.span_key(): (g, "float32")},
                                 3 * bound * 4)
    assert abs(got - 25.0) < 1e-9
    assert convwork.conv_roofline([], {}, 1.0) is None


def test_the_parameter_count_equals_the_leaves_drawn():
    cfg = _tiny.cell("mamba2-370m-nobias-bf16res.train-8x2048").config
    drawn = sum(v.numel() for v in MP.make(cfg, 5, "cpu").values())
    assert lmwork.mamba2_param_count(cfg) == drawn


def test_model_flops_equals_the_programs_count_at_smoke_size():
    """The copy against the program's own ``launch/dryrun.py::
    model_flops`` on the program's parameter tree of the same sizes."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from portbench.lib.bench import load_module
    cell = _tiny.cell("mamba2-370m-nobias-bf16res.train-8x2048")
    arch = load_module(cell.root, "drivers", "lm_train").arch_config(
        cell.config)
    meta = M.init_params(torch.Generator(), arch, "meta")
    want = dryrun.model_flops(arch, ShapeCfg("t", 128, 4, "train"), meta)
    got = lmwork.model_flops(lmwork.mamba2_param_count(cell.config), 4 * 128)
    assert got == want
