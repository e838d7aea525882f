"""The CUDA kernels on the card: each tap-GEMM kernel, ``matmul`` and
``flash_attention`` against its plain version (head dims up to 256), a
prefill's one kernel launch per layer against a lockstep scan of decode
steps (SmolLM-360M, the MoE family with GQA and MLA, and the hybrid
family's RG-LRU and local-window layers), ``conv2d``
under ``pallas``, ``traditional`` and ``bp_im2col`` against ``lax``,
``conv2d_transpose`` against its ``lax`` materialization, determinism
of the split-K sums, launch counting, 20 training steps against ``lax``,
the measured autotuner (every candidate plan against the plain version,
tuning from inside ``backward``, and a ``cached`` process served only
hits), the flash wrapper's refusal of a tensor that requires grad, one
full-width LM train step, and the tap kernels' bf16 instances (Mamba2's
depthwise conv at its 2,304 groups and a grouped strided layer against
their plain versions, ``depthwise_causal_conv1d`` under ``pallas``
against ``lax`` in bf16, mixed operand types refused, a plan past the
grid's z limit refused, float32 and bf16 plans tuned apart), and the
depthwise variant ``dw`` of the forward, the input grad and the weight
grad (Mamba2's geometry, ragged lengths, operands off a 16-byte boundary,
the CNN's 3 x 3 in float32, a stride-2 3 x 3, a 7 x 7, 4,096 and 70,000
groups; the input grad also at a 7 x 7 at stride 2, phases without taps,
and rows misaligned by 1-7 elements; the tiles it replaces still right at
its geometry); and fault injection on the card (a faulted tap-kernel
pass served by ``bp_phase`` with no launch, a quarantine probe that
launches the kernel again, a failed decode lane on flash serving; a
kernel or prefill that raises anything but an injected fault fails its
call).

Every test needs an NVIDIA GPU and skips without one.  This file imports no
JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.convspec import ConvSpec, ConvTransposeSpec  # noqa: E402,E501
from repro_torch.core.im2col_ref import ConvDims  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402,E501
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import tap_gemm as tg  # noqa: E402
from repro_torch.kernels.matmul import matmul  # noqa: E402

pytestmark = pytest.mark.cuda

#: float32 sums in another order than the plain version or the library:
#: max |a - b| <= REL_TOL * max |b| (the measure chip_smoke.py uses).  A
#: pointwise tolerance does not fit: the weight grad sums up to 24,642
#: products, so an element that cancels to near zero carries the rounding
#: of terms ~1e3 times its size.
REL_TOL = 1e-4


def _close(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * max(want.abs().max().item(), 1e-6), err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels cannot run here")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _randn(gen, *shape, dev):
    return torch.randn(*shape, generator=gen).to(dev)


GEOMS = [
    dict(B=2, C=3, H=16, N=16, K=3, S=2, P=1, G=1),
    dict(B=2, C=70, H=9, N=130, K=3, S=3, P=1, G=1),
    dict(B=3, C=1, H=8, N=1, K=3, S=1, P=1, G=16),
    dict(B=2, C=24, H=12, N=20, K=1, S=2, P=0, G=2),
    dict(B=2, C=5, H=40, N=9, K=3, S=2, P=0, G=1),
]


@pytest.mark.parametrize("g", GEOMS,
                         ids=lambda g: "C{C}N{N}K{K}S{S}G{G}".format(**g))
def test_kernels_match_plain_versions(cuda, g):
    d = ConvDims(B=g["B"], C=g["C"], H_i=g["H"], W_i=g["H"], N=g["N"],
                 K_h=g["K"], K_w=g["K"], S=g["S"], P_h=g["P"], P_w=g["P"])
    gen = torch.Generator().manual_seed(0)
    x = _randn(gen, d.B, d.C * g["G"], d.H_i, d.W_i, dev=cuda)
    w = _randn(gen, d.N * g["G"], d.C, d.K_h, d.K_w, dev=cuda)
    dy = _randn(gen, d.B, d.N * g["G"], d.H_o, d.W_o, dev=cuda)
    src, wt, taps = ops.forward_operands(x, w, d, g["G"])
    _close(tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
           ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o))
    src, ws, pp = ops.input_grad_operands(dy, w, d, g["G"])
    _close(
        tg.tap_gemm_phased(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw),
        ref.tap_gemm_phased_ref(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw))
    src, dyn, taps = ops.weight_grad_operands(x, dy, d, g["G"])
    _close(tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o),
           ref.tap_wgrad_ref(src, dyn, taps, d.H_o, d.W_o))


CONV_CASES = [
    ((2, 3, 9, 9), (4, 3, 3, 3), dict(stride=2, padding=1)),
    ((1, 3, 10, 12), (4, 3, 3, 3), dict(stride=(2, 3), padding=1)),
    ((1, 2, 11, 11), (3, 2, 3, 3), dict(stride=2, padding=2, dilation=2)),
    ((2, 3, 9, 10), (2, 3, 3, 3), dict(stride=2, padding=((0, 2), (2, 1)))),
    ((2, 16, 8, 8), (16, 1, 3, 3), dict(stride=1, padding=1, groups=16)),
    ((2, 8, 12, 12), (12, 4, 3, 3), dict(stride=3, padding=1, groups=2)),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["s2", "s2x3", "d2", "asympad", "dw", "g2s3"])
def test_conv2d_pallas_matches_lax_and_launches_once_per_pass(cuda, case):
    x_shape, w_shape, kw = case
    spec = ConvSpec.make(**kw)
    gen = torch.Generator().manual_seed(1)
    x0, w0 = _randn(gen, *x_shape, dev=cuda), _randn(gen, *w_shape, dev=cuda)
    d = tconv.spec_dims(x_shape, w_shape, spec)
    dy = _randn(gen, d.B, d.N * spec.groups, d.H_o, d.W_o, dev=cuda)
    out = {}
    for policy in ("pallas", "lax"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        tg.reset_launch_counts()
        y = tconv.conv2d(x, w, spec, policy)
        y.backward(dy)
        out[policy] = (y.detach(), x.grad, w.grad, tg.launch_counts())
    for a, b in zip(out["pallas"][:3], out["lax"][:3]):
        _close(a, b)
    assert out["pallas"][3] == {"tap_gemm": 1, "tap_gemm_phased": 1,
                                "tap_wgrad": 1}
    assert out["lax"][3] == {"tap_gemm": 0, "tap_gemm_phased": 0,
                             "tap_wgrad": 0}


def test_split_k_weight_grad_is_deterministic(cuda):
    """The 224/3->64 layer splits its 24,642-row contraction; partials are
    summed in a fixed order, so two runs agree bit for bit."""
    d = ConvDims(B=2, C=3, H_i=224, W_i=224, N=64, K_h=3, K_w=3, S=2)
    gen = torch.Generator().manual_seed(2)
    x = _randn(gen, d.B, d.C, d.H_i, d.W_i, dev=cuda)
    dy = _randn(gen, d.B, d.N, d.H_o, d.W_o, dev=cuda)
    src, dyn, taps = ops.weight_grad_operands(x, dy, d)
    a = tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o)
    b = tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o)
    assert torch.equal(a, b)
    _close(a, ref.tap_wgrad_ref(src, dyn, taps, d.H_o, d.W_o))


@pytest.mark.parametrize("layer", [(28, 244, 244, 3, 2, 1),
                                   (14, 1024, 2048, 1, 2, 0),
                                   (224, 3, 64, 3, 2, 0)],
                         ids=["L4", "L5", "L1"])
def test_forward_split_k_matches_plain_version_and_is_deterministic(cuda,
                                                                    layer):
    """Table II layers 4 and 5 split the forward's (tap, channel)
    contraction over 9 and 4 blocks; layer 1 (C = 3, 4-byte copies) does
    not split.  Partials are summed in a fixed order: runs agree bit for
    bit."""
    from repro_torch.configs import paper_cnn
    d = paper_cnn.dims(layer)
    gen = torch.Generator().manual_seed(8)
    x = _randn(gen, d.B, d.C, d.H_i, d.W_i, dev=cuda)
    w = _randn(gen, d.N, d.C, d.K_h, d.K_w, dev=cuda)
    src, wt, taps = ops.forward_operands(x, w, d)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = tg.forward_splits(d.B * d.H_o * d.W_o, d.N, len(taps), d.C, sms)
    assert (splits > 1) == (d.C > 3)
    reset_launch_counts()
    a = tg.tap_gemm(src, wt, taps, d.H_o, d.W_o)
    b = tg.tap_gemm(src, wt, taps, d.H_o, d.W_o)
    assert launch_counts()["tap_gemm"] == 2
    assert torch.equal(a, b)
    _close(a, ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    src = torch.zeros(1, 1, 4, 4, 3, device=cuda)
    w = torch.zeros(1, 3, 2, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tg.tap_gemm(src.double(), w.double(), [(0, 0, 0)], 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tg.tap_gemm(src, w.transpose(1, 2).contiguous().transpose(1, 2),
                    [(0, 0, 0)], 3, 3)


def test_training_losses_match_lax(cuda):
    from repro_torch.train import cnn_bp
    tg.reset_launch_counts()
    got = cnn_bp.train("pallas", steps=20, device=cuda)
    counts = tg.launch_counts()
    want = cnn_bp.train("lax", steps=20, device=cuda)
    _close(torch.tensor(got["losses"]), torch.tensor(want["losses"]))
    assert all(v > 0 for v in counts.values()), counts


#: bf16 outputs: both sides round the float32 sum to bfloat16 (2^-8
#: relative) after summing in another order, so they may differ by one
#: bf16 step of the largest value.  bf16 flash attention also rounds each
#: probability to bf16 (2^-9 relative) before its P V product.
BF16_TOL = 1e-2

MATMULS = [(24_642, 27, 64), (6_272, 576, 64), (1, 7, 3), (3, 576, 10_000),
           (27, 97_682, 64), (98, 1_024, 2_048), (10_000, 576, 3),
           (2_048, 27, 16), (27, 7_200, 16), (1_000, 13, 10)]


@pytest.mark.parametrize("mkn", MATMULS, ids=lambda t: "x".join(map(str, t)))
def test_matmul_matches_plain_version(cuda, mkn):
    m, k, n = mkn
    gen = torch.Generator().manual_seed(3)
    a, b = _randn(gen, m, k, dev=cuda), _randn(gen, k, n, dev=cuda)
    reset_launch_counts()
    _close(matmul(a, b), ref.matmul_ref(a, b))
    assert launch_counts()["matmul"] == 1


def test_matmul_groups_bf16_and_split_k_determinism(cuda):
    gen = torch.Generator().manual_seed(4)
    a, b = _randn(gen, 3, 70, 300, dev=cuda), _randn(gen, 3, 300, 50, dev=cuda)
    _close(matmul(a, b), ref.matmul_ref(a, b))
    ab, bb = a.bfloat16(), b.bfloat16()
    for out_dtype in (None, torch.float32):
        got = matmul(ab, bb, out_dtype=out_dtype)
        want = ref.matmul_ref(ab, bb, out_dtype)
        assert got.dtype == want.dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_TOL * want.float().abs().max().item(), err
    # One output tile over 97,682 rows: split-K, summed in a fixed order.
    a, b = _randn(gen, 27, 97_682, dev=cuda), _randn(gen, 97_682, 64,
                                                      dev=cuda)
    assert torch.equal(matmul(a, b), matmul(a, b))


def test_matmul_raises_on_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(4, 5, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        matmul(a.double(), a.double().t().contiguous())
    with pytest.raises(TypeError, match="one type"):
        matmul(a, torch.zeros(5, 4, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        matmul(a, torch.zeros(4, 5, device=cuda).t())


@pytest.mark.parametrize("policy", ["traditional", "bp_im2col"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["s2", "s2x3", "d2", "asympad", "dw", "g2s3"])
def test_conv2d_baseline_engines_match_lax_on_matmul(cuda, case, policy):
    x_shape, w_shape, kw = case
    spec = ConvSpec.make(**kw)
    gen = torch.Generator().manual_seed(5)
    x0, w0 = _randn(gen, *x_shape, dev=cuda), _randn(gen, *w_shape, dev=cuda)
    d = tconv.spec_dims(x_shape, w_shape, spec)
    dy = _randn(gen, d.B, d.N * spec.groups, d.H_o, d.W_o, dev=cuda)
    out = {}
    for p in (policy, "lax"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        reset_launch_counts()
        y = tconv.conv2d(x, w, spec, p)
        y.backward(dy)
        out[p] = (y.detach(), x.grad, w.grad, launch_counts()["matmul"])
    for a, b in zip(out[policy][:3], out["lax"][:3]):
        _close(a, b)
    assert out[policy][3] == 3 and out["lax"][3] == 0


@pytest.mark.parametrize("policy", ["pallas", "traditional"])
def test_conv2d_transpose_matches_materialized_lax(cuda, policy):
    from repro_torch.core.convspec import ConvTransposeSpec
    spec = ConvTransposeSpec.make(stride=2, padding=1, output_padding=1)
    gen = torch.Generator().manual_seed(6)
    x0 = _randn(gen, 2, 32, 8, 8, dev=cuda)
    w0 = _randn(gen, 32, 16, 3, 3, dev=cuda)
    dy = _randn(gen, 2, 16, 16, 16, dev=cuda)
    out = {}
    for p in (policy, "oracle"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        reset_launch_counts()
        y = (tconv.conv2d_transpose_materialized(x, w, spec, "lax")
             if p == "oracle" else tconv.conv2d_transpose(x, w, spec, p))
        if p != "oracle":
            fwd = launch_counts()
        y.backward(dy)
        out[p] = (y.detach(), x.grad, w.grad)
    for a, b in zip(out[policy], out["oracle"]):
        _close(a, b)
    if policy == "pallas":
        assert fwd["tap_gemm_phased"] == 1 and fwd["matmul"] == 0
    else:
        assert fwd["matmul"] == 1 and fwd["tap_gemm_phased"] == 0


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _shifted(gen, *shape, dev, dtype=torch.float32):
    """A contiguous tensor whose base lies one element past a 16-byte
    boundary (a view offset by one element)."""
    n = 1
    for v in shape:
        n *= v
    buf = torch.randn(n + 1, generator=gen).to(dev, dtype)
    out = buf[1:].view(shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


#: weight grads of each variant and copy width: the (tap, channel) rows of
#: a tile span tap boundaries at C = 3 and C = 5 (4-byte copies), COUT 9
#: and 1 take 4-byte copies of dy, the depthwise conv is 16 groups of one
#: channel split 32 ways.
WGRAD_GEOMS = [
    dict(B=4, C=3, H=17, N=16, K=3, S=2, P=1, G=1),
    dict(B=2, C=5, H=21, N=9, K=3, S=1, P=1, G=1),
    dict(B=2, C=5, H=21, N=40, K=3, S=2, P=0, G=1),
    dict(B=32, C=1, H=8, N=1, K=3, S=1, P=1, G=16),
    dict(B=4, C=16, H=16, N=32, K=3, S=2, P=1, G=1),
    dict(B=2, C=64, H=30, N=64, K=3, S=2, P=1, G=2),
]


@pytest.mark.parametrize("g", WGRAD_GEOMS,
                         ids=lambda g: "C{C}N{N}S{S}G{G}".format(**g))
def test_tap_wgrad_variants_match_plain_version_and_are_deterministic(cuda,
                                                                      g):
    d = ConvDims(B=g["B"], C=g["C"], H_i=g["H"], W_i=g["H"], N=g["N"],
                 K_h=g["K"], K_w=g["K"], S=g["S"], P_h=g["P"], P_w=g["P"])
    gen = torch.Generator().manual_seed(9)
    x = _randn(gen, d.B, d.C * g["G"], d.H_i, d.W_i, dev=cuda)
    dy = _randn(gen, d.B, d.N * g["G"], d.H_o, d.W_o, dev=cuda)
    src, dyn, taps = ops.weight_grad_operands(x, dy, d, g["G"])
    variant, splits = tg.wgrad_plan(g["G"], len(taps), d.C, d.N,
                                    d.B * d.H_o * d.W_o, _sms(cuda))
    assert variant == ("64x16" if d.N <= 16 else "64x64")
    reset_launch_counts()
    a = tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o)
    b = tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o)
    assert launch_counts()["tap_wgrad"] == 2
    assert torch.equal(a, b), (variant, splits)
    _close(a, ref.tap_wgrad_ref(src, dyn, taps, d.H_o, d.W_o))


#: (G, M, K, N) of the 128 x 8 and 8 x 128 tiles: edges of 3 (layer 1's
#: and the CNN's input grads) and of 1 with 16 groups (the depthwise
#: conv), K % 4 != 0 (4-byte copies of the streamed operand), N % 4 != 0,
#: and a split contraction.
EDGE_GEMMS = [(1, 8192, 144, 3), (1, 3, 144, 8192), (16, 2048, 9, 1),
              (16, 1, 9, 2048), (16, 9, 2048, 1), (1, 10_000, 27, 3),
              (1, 3, 27, 10_000), (1, 2, 300, 1001), (1, 100_352, 576, 3)]


@pytest.mark.parametrize("gmkn", EDGE_GEMMS,
                         ids=lambda t: "x".join(map(str, t)))
def test_matmul_edge_tiles_match_plain_version_and_are_deterministic(cuda,
                                                                     gmkn):
    g, m, k, n = gmkn
    variant, splits = mm.matmul_plan(g, m, k, n, _sms(cuda))
    assert variant == ("128x8" if n <= m else "8x128")
    gen = torch.Generator().manual_seed(10)
    a, b = _randn(gen, g, m, k, dev=cuda), _randn(gen, g, k, n, dev=cuda)
    reset_launch_counts()
    got, again = matmul(a, b), matmul(a, b)
    assert launch_counts()["matmul"] == 2
    assert torch.equal(got, again), (variant, splits)
    _close(got, ref.matmul_ref(a, b))


def test_kernels_take_operands_off_a_16_byte_boundary(cuda):
    """Operands whose base is one float past a 16-byte boundary take the
    kernels' 4-byte copies (CIN, COUT, K and N are multiples of 4, so only
    the base rules out 16-byte copies)."""
    gen = torch.Generator().manual_seed(11)
    d = ConvDims(B=2, C=16, H_i=12, W_i=12, N=32, K_h=3, K_w=3, S=2, P_h=1,
                 P_w=1)
    x = _randn(gen, d.B, d.C, d.H_i, d.W_i, dev=cuda)
    dy = _randn(gen, d.B, d.N, d.H_o, d.W_o, dev=cuda)
    src, dyn, taps = ops.weight_grad_operands(x, dy, d)
    src_s = _shifted(gen, *src.shape, dev=cuda).copy_(src)
    dyn_s = _shifted(gen, *dyn.shape, dev=cuda).copy_(dyn)
    _close(tg.tap_wgrad(src_s, dyn_s, taps, d.H_o, d.W_o),
           ref.tap_wgrad_ref(src, dyn, taps, d.H_o, d.W_o))
    for m, k, n in [(300, 64, 96), (1000, 64, 4), (4, 64, 1000)]:
        a = _shifted(gen, m, k, dev=cuda)
        b = _shifted(gen, k, n, dev=cuda)
        _close(matmul(a, b), ref.matmul_ref(a, b))


@pytest.mark.parametrize("gmkn", [(1, 300, 200, 100), (1, 3000, 96, 3),
                                  (2, 5, 96, 3000), (1, 27, 5000, 64),
                                  (1, 1000, 27, 16)],
                         ids=lambda t: "x".join(map(str, t)))
def test_matmul_bf16_in_every_tile_with_f32_and_bf16_out(cuda, gmkn):
    """bf16 operands (converted to float32 as they are staged) in each
    tile, split and not, with float32 and bf16 outputs."""
    g, m, k, n = gmkn
    gen = torch.Generator().manual_seed(12)
    a = _randn(gen, g, m, k, dev=cuda).bfloat16()
    b = _randn(gen, g, k, n, dev=cuda).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = matmul(a, b, out_dtype=out_dtype)
        want = ref.matmul_ref(a, b, out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, matmul(a, b, out_dtype=out_dtype))
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_TOL * want.float().abs().max().item(), err


#: flash attention, float32: online softmax against the plain version's
#: full-row softmax, sums in another order.
FLASH_TOL = 1e-5

#: (B, H, Hk, Lq, Lk, D, causal, dtype)
FLASH_CASES = [
    (1, 15, 5, 1024, 1024, 64, True, torch.float32),   # SmolLM prefill
    (1, 15, 5, 1000, 1000, 64, True, torch.bfloat16),  # ragged, bf16
    (2, 4, 4, 200, 200, 128, True, torch.float32),     # Hk == H, D = 128
    (1, 6, 2, 256, 1024, 64, True, torch.float32),     # Lq < Lk
    (1, 3, 1, 77, 130, 16, False, torch.float32),      # full, small D
    (1, 4, 2, 1, 33, 100, True, torch.bfloat16),       # one row, odd D
    # bf16 runs on the tensor cores: D = 128, rows of D = 100 that are not
    # 16-byte aligned (plain loads), Lq < Lk, and one query row.
    (1, 4, 2, 200, 200, 128, True, torch.bfloat16),
    (1, 4, 2, 77, 130, 100, True, torch.bfloat16),
    (1, 3, 1, 77, 130, 100, False, torch.bfloat16),
    (1, 6, 2, 256, 1024, 64, True, torch.bfloat16),
    (1, 15, 5, 1, 1024, 64, True, torch.bfloat16),
    # D up to 192 (DeepSeek-V3 MLA's qk_nope + qk_rope): causal and ragged,
    # Lq < Lk, full with GQA, and rows of D = 180 that are not 16-byte
    # aligned.
    (1, 8, 8, 300, 300, 192, True, torch.bfloat16),
    (1, 8, 8, 300, 300, 192, True, torch.float32),
    (1, 4, 4, 64, 256, 192, True, torch.bfloat16),
    (1, 4, 4, 64, 256, 192, True, torch.float32),
    (1, 4, 2, 100, 130, 160, False, torch.float32),
    (1, 4, 2, 77, 130, 180, True, torch.bfloat16),
    # D up to 256 (recurrentgemma-9b: 16 query heads of 256 against one
    # KV head): causal and ragged, full with Hk == H, Lq < Lk, and rows of
    # D = 250 that are not 16-byte aligned.
    (1, 16, 1, 1000, 1000, 256, True, torch.bfloat16),
    (1, 16, 1, 1000, 1000, 256, True, torch.float32),
    (1, 4, 4, 200, 200, 256, False, torch.bfloat16),
    (1, 4, 4, 200, 200, 256, False, torch.float32),
    (1, 4, 1, 64, 300, 256, True, torch.bfloat16),
    (1, 4, 1, 64, 300, 256, True, torch.float32),
    (2, 4, 2, 77, 130, 250, True, torch.bfloat16),
    (1, 4, 2, 1, 130, 256, True, torch.bfloat16),
    # hubert-xlarge's encoder: 16 heads of 80 (the D-128 instance, zero
    # past D), full attention over 1,000 frames (20 s at 50 frames/s).
    (4, 16, 16, 1000, 1000, 80, False, torch.bfloat16),
    (4, 16, 16, 1000, 1000, 80, False, torch.float32),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "H{}Hk{}q{}k{}D{}"
                         "{}{}".format(*c[1:6], "c" if c[6] else "f",
                                       str(c[7])[-4:]))
def test_flash_attention_matches_plain_version(cuda, case):
    from repro_torch.kernels.flash_attention import flash_attention
    b, h, hk, lq, lk, d, causal, dtype = case
    gen = torch.Generator().manual_seed(7)
    q = _randn(gen, b, h, lq, d, dev=cuda).to(dtype)
    k = _randn(gen, b, hk, lk, d, dev=cuda).to(dtype)
    v = _randn(gen, b, hk, lk, d, dev=cuda).to(dtype)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    assert launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    tol = FLASH_TOL if dtype == torch.float32 else BF16_TOL
    assert err <= tol * want.float().abs().max().item(), err
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))


def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="one type"):
        flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q.transpose(2, 3).contiguous().transpose(2, 3), q)
    wide = torch.zeros(1, 2, 8, 300, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(wide.bfloat16(), wide.bfloat16(), wide.bfloat16())


def test_flash_attention_refuses_a_tensor_that_requires_grad(cuda):
    """The kernel has no backward: a grad-carrying call raises before any
    launch instead of returning an output without a grad_fn."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator().manual_seed(3)
    q = _randn(gen, 1, 3, 16, 16, dev=cuda).requires_grad_(True)
    kv = _randn(gen, 1, 1, 16, 16, dev=cuda)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, kv, kv)
    assert launch_counts()["flash_attention"] == 0
    with torch.no_grad():
        flash_attention(q, kv, kv)
    flash_attention(q.detach(), kv, kv)
    assert launch_counts()["flash_attention"] == 2


def test_full_width_train_step_shapes_and_dtypes(cuda):
    """One guarded train step of SmolLM-360M at its published widths (bf16)
    on a short batch: every parameter keeps its shape, bf16 type and
    device, the moments stay float32, the step count and the streak are
    int32 on the card, the loss is finite, and no kernel launches (the
    attention under autograd is the dense plain version)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    from repro_torch.tree import tree_leaves
    cfg = get_config("smollm-360m")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    opt = adamw.init_state(params)
    step = TS.make_train_step(cfg, adamw.AdamWConfig(peak_lr=3e-3),
                              total_steps=10, warmup=1, guard=True)
    dcfg = DataConfig(seed=0, seq_len=128, global_batch=2, vocab=cfg.vocab)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, dcfg, 0).items()}
    reset_launch_counts()
    new, new_opt, metrics = step(params, opt, batch, 0)
    assert not any(launch_counts().values())
    assert M.count_params(new) == 361_821_120
    for p, q in zip(tree_leaves(params), tree_leaves(new)):
        assert (q.shape, q.dtype, q.device) == (p.shape, torch.bfloat16,
                                                p.device)
    for key in ("m", "v"):
        assert all(t.dtype == torch.float32
                   for t in tree_leaves(new_opt[key]))
    for key in ("step", "guard_streak"):
        t = new_opt[key]
        assert (t.shape, t.dtype, t.device.type) == ((), torch.int32, "cuda")
    assert int(new_opt["step"]) == 1 and int(new_opt["guard_streak"]) == 0
    assert bool(torch.isfinite(metrics["loss"])) \
        and float(metrics["guard_bad"]) == 0.0


def test_prefill_launches_the_kernel_once_per_layer(cuda):
    """The port's prefill (one causal pass, the kernel in every layer)
    against a lockstep scan of decode steps (plain dense attention, no
    launch) on the card, at the smoke config in float32."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("smollm-360m")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 45),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    reset_launch_counts()
    logits, cache = M.prefill(params, toks, cfg, 50)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    scan = T.init_cache(cfg, 2, 50, cuda)
    for t in range(toks.shape[1]):
        want, scan = M.decode_step(params, scan, toks[:, t], t, cfg)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    _close(logits, want)
    for key in ("k", "v"):
        _close(cache["blocks"][key], scan["blocks"][key])


def test_audio_encoder_forward_runs_full_flash_once_per_layer(cuda,
                                                              monkeypatch):
    """hubert-xlarge's smoke config in float32 on the card: a no-grad
    forward launches the kernel once a layer, non-causal, and equals the
    grad-mode forward (dense attention, no launch); position 0 reads the
    last frame."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    cfg = get_smoke_config("hubert-xlarge")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    frames = _randn(torch.Generator().manual_seed(1), 2, 300, cfg.d_frontend,
                    dev=cuda)
    calls = []
    spy = A.flash_attention
    monkeypatch.setattr(A, "flash_attention", lambda *a, **k: calls.append(
        k["causal"]) or spy(*a, **k))
    reset_launch_counts()
    with torch.no_grad():
        got, _ = M.forward(params, {"frontend": frames}, cfg)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    assert calls == [False] * cfg.n_layers
    frames.requires_grad_(True)
    want, _ = M.forward(params, {"frontend": frames}, cfg)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    _close(got, want.detach())
    later = frames.detach().clone()
    later[:, -1] += 1.0
    with torch.no_grad():
        moved = M.forward(params, {"frontend": later}, cfg)[0]
    assert (moved[:, 0] - got[:, 0]).abs().max().item() > 1e-3


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_prefill_launches_the_kernel_once_per_layer(cuda, arch):
    """The MoE family's one-pass prefill (GQA, or MLA at its smoke head dim
    24) against the lockstep decode scan on the card, at the smoke config
    in float32: one launch per layer, none in the scan, logits and every
    layer's cache within the float32 tolerance."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_smoke_config(arch)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 300),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    reset_launch_counts()
    logits, cache = M.prefill(params, toks, cfg, 304)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    scan = T.init_cache(cfg, 2, 304, cuda)
    for t in range(toks.shape[1]):
        want, scan = M.decode_step(params, scan, toks[:, t], t, cfg)
    assert launch_counts()["flash_attention"] == cfg.n_layers
    _close(logits, want)
    for name in cache:
        for key in cache[name]:
            _close(cache[name][key], scan[name][key])


@pytest.mark.parametrize("plen", [30, 45])
def test_hybrid_prefill_matches_the_decode_scan(cuda, plen):
    """recurrentgemma-9b's smoke config (window 32) in float32 under
    ``pallas``: the one-pass prefill launches ``tap_gemm`` once a
    recurrent layer and, for a prompt that fits the window, the flash
    kernel once an attention layer (none past it: the masked plain
    attention runs); the decode scan launches neither.  Logits and every
    cache leaf match the scan."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              conv_policy="pallas")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)
    toks = torch.randint(0, cfg.vocab, (2, plen),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    reset_launch_counts()
    logits, cache = M.prefill(params, toks, cfg, plen + 4)
    counts = launch_counts()
    assert counts["tap_gemm"] == 3
    assert counts["flash_attention"] == (1 if plen <= cfg.local_window
                                         else 0)
    reset_launch_counts()
    scan = T.init_cache(cfg, 2, plen + 4, cuda)
    for t in range(plen):
        want, scan = M.decode_step(params, scan, toks[:, t], t, cfg)
    assert not any(launch_counts().values())
    _close(logits, want)
    for got, ref_ in zip(tree_leaves(cache), tree_leaves(scan)):
        _close(got, ref_)


#: input grads of each variant and copy width, as (x shape, w shape, conv
#: spec): COUT 3 (128 x 8 tile, 4-byte copies of the weights); COUT 1 with
#: 16 groups (the depthwise conv, CIN 1); CIN 5 (4-byte copies of dY, a
#: step of 16 rows spans taps) into COUT 12 (64 x 16); a 1x1 stride-2 conv
#: (three phases without taps) that splits its one phase; stride (2, 3),
#: whose six phases run 1, 1, 1, 2, 2 and 2 taps; stride 3 with a 2x2
#: kernel (phases without taps, COUT 6 on the 128 x 8 tile).
PHASED_GEOMS = [
    ((2, 3, 33, 33), (64, 3, 3, 3), dict(stride=2)),
    ((4, 16, 12, 12), (16, 1, 3, 3), dict(stride=1, padding=1, groups=16)),
    ((2, 12, 17, 17), (5, 12, 3, 3), dict(stride=2, padding=1)),
    ((2, 256, 28, 28), (512, 256, 1, 1), dict(stride=2)),
    ((2, 20, 14, 15), (24, 20, 3, 3), dict(stride=(2, 3), padding=1)),
    ((2, 6, 13, 13), (10, 6, 2, 2), dict(stride=3)),
]


def _phased_operands(cuda, case, seed=13):
    x_shape, w_shape, kw = case
    spec = ConvSpec.make(**kw)
    d = tconv.spec_dims(x_shape, w_shape, spec)
    gen = torch.Generator().manual_seed(seed)
    w = _randn(gen, *w_shape, dev=cuda)
    dy = _randn(gen, d.B, d.N * spec.groups, d.H_o, d.W_o, dev=cuda)
    src, ws, pp = ops.input_grad_operands(dy, w, d, spec.groups)
    counts = [len(t) for t in pp.phase_taps]
    plan = tg.phased_plan(spec.groups, counts, d.N, d.C,
                          d.B * pp.n_qh * pp.n_qw, _sms(cuda))
    return src, ws, pp, counts, plan


def _phased_matches(src, ws, phase_taps, oh, ow, plan=None):
    reset_launch_counts()
    got = tg.tap_gemm_phased(src, ws, phase_taps, oh, ow, plan)
    again = tg.tap_gemm_phased(src, ws, phase_taps, oh, ow, plan)
    assert launch_counts()["tap_gemm_phased"] == 2
    assert torch.equal(got, again)
    _close(got, ref.tap_gemm_phased_ref(src, ws, phase_taps, oh, ow))
    return got


@pytest.mark.parametrize("case", PHASED_GEOMS,
                         ids=["cout3", "dw_g16", "cin5", "1x1s2split",
                              "s2x3", "s3empty"])
def test_tap_gemm_phased_variants_match_plain_version(cuda, case):
    """Each tile at the geometries above, given as its plan (the depthwise
    case's analytic plan is ``dw``; its tile still runs when asked)."""
    src, ws, pp, counts, (variant, splits) = _phased_operands(cuda, case)
    cout = ws.shape[-1]
    assert variant == ("128x8" if cout <= 8 else
                       "64x16" if cout <= 16 else "64x64")
    got = _phased_matches(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw,
                          tg.Plan("input_grad", variant, splits))
    assert tg.variant_launch_counts() == {f"tap_gemm_phased:{variant}": 2}
    for p, n in enumerate(counts):
        if n == 0:
            assert not got[:, p].any()


def test_tap_gemm_phased_splits_only_the_active_phase(cuda):
    """The 1x1 stride-2 conv splits its one active phase; its three
    inactive phases are zeros stored straight into the output."""
    src, ws, pp, counts, (variant, splits) = _phased_operands(
        cuda, PHASED_GEOMS[3])
    assert counts == [1, 0, 0, 0] and splits > 1
    work, sums, slots = tg.phased_work(counts, ws.shape[-2], splits,
                                       tg.PHASED_TILES[variant].step)
    assert slots == splits and sums == ((0, 0, splits),)
    _phased_matches(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw)


def test_tap_gemm_phased_takes_an_unaligned_src_and_any_tap_slot(cuda):
    """dY whose base is one float past a 16-byte boundary takes the 4-byte
    copies (CIN 24 would take 16-byte ones); a tap table whose weight slot
    j is not the tap's position reads slot j."""
    src, ws, pp, counts, _ = _phased_operands(cuda, PHASED_GEOMS[4])
    gen = torch.Generator().manual_seed(14)
    src_s = _shifted(gen, *src.shape, dev=cuda).copy_(src)
    _phased_matches(src_s, ws, pp.phase_taps, pp.n_qh, pp.n_qw)
    t = ws.shape[2]                                   # (G, PH, T, N, C)
    perm = [(j * 3 + 1) % t for j in range(t)]        # t = 2: 1, 0
    assert sorted(perm) == list(range(t)) and perm != list(range(t))
    w2 = torch.empty_like(ws)
    w2[:, :, perm] = ws
    taps2 = tuple(tuple((perm[j], du, dv) for j, du, dv in taps)
                  for taps in pp.phase_taps)
    want = _phased_matches(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw)
    got = _phased_matches(src, w2, taps2, pp.n_qh, pp.n_qw)
    _close(got, want)


# ---------------------------------------------------------------------------
# Measured autotuning (kernels/autotune.py)
# ---------------------------------------------------------------------------

_DEC = ConvTransposeSpec.make(stride=2, padding=1, output_padding=1)

#: the training shapes: the CNN's three convs (batch 32) and the
#: autoencoder's two encoder convs and its decoder layers' mirror convs
#: (batch 16), as (per-group dims, groups) -- chip_smoke.py's cnn_shapes and
#: ae_shapes.
TRAIN_SHAPES = [
    (ConvDims(B=32, C=3, H_i=16, W_i=16, N=16, K_h=3, K_w=3, S=2, P_h=1,
              P_w=1), 1),
    (ConvDims(B=32, C=1, H_i=8, W_i=8, N=1, K_h=3, K_w=3, S=1, P_h=1,
              P_w=1), 16),
    (ConvDims(B=32, C=16, H_i=8, W_i=8, N=32, K_h=3, K_w=3, S=2, P_h=1,
              P_w=1), 1),
    (ConvDims(B=16, C=3, H_i=16, W_i=16, N=16, K_h=3, K_w=3, S=2, P_h=1,
              P_w=1), 1),
    (ConvDims(B=16, C=16, H_i=8, W_i=8, N=32, K_h=3, K_w=3, S=2, P_h=1,
              P_w=1), 1),
    (tconv.transpose_dims((16, 32, 4, 4), (32, 16, 3, 3), _DEC), 1),
    (tconv.transpose_dims((16, 16, 8, 8), (16, 3, 3, 3), _DEC), 1),
]


@pytest.fixture
def tuned(cuda, tmp_path):
    """autotune=measure over a private plan cache; config restored, memo
    and counters dropped."""
    from repro_torch.core.config import config
    from repro_torch.kernels import autotune
    saved = config.snapshot()
    config.update(autotune="measure", plan_cache_dir=str(tmp_path))
    autotune.clear_memo()
    ops.reset_plan_events()
    yield tmp_path
    config.update(**saved)
    autotune.clear_memo()
    ops.reset_plan_events()


@pytest.mark.parametrize("d,g", TRAIN_SHAPES,
                         ids=["cnn.c1", "cnn.dw", "cnn.c2", "ae.enc0",
                              "ae.enc1", "ae.dec0", "ae.dec1"])
def test_every_candidate_matches_the_plain_version(cuda, d, g):
    """Every plan the tuner may pick, each role, at the training shapes:
    within REL_TOL of the plain version and bit-equal run to run."""
    gen = torch.Generator().manual_seed(21)
    x = _randn(gen, d.B, d.C * g, d.H_i, d.W_i, dev=cuda)
    w = _randn(gen, d.N * g, d.C, d.K_h, d.K_w, dev=cuda)
    dy = _randn(gen, d.B, d.N * g, d.H_o, d.W_o, dev=cuda)
    src, wt, taps = ops.forward_operands(x, w, d, g)
    gsrc, ws, pp = ops.input_grad_operands(dy, w, d, g)
    wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
    calls = {
        "forward": (lambda p: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o, p),
                    ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o)),
        "input_grad": (lambda p: tg.tap_gemm_phased(
            gsrc, ws, pp.phase_taps, pp.n_qh, pp.n_qw, p),
            ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps, pp.n_qh,
                                    pp.n_qw)),
        "weight_grad": (lambda p: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o,
                                               d.W_o, p),
                        ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o))}
    timed = 0
    for role, (kern, want) in calls.items():
        cands = ops.plan_candidates(role, d, g, k=100, device=cuda)
        timed += len(cands)
        for plan in cands:
            got = kern(plan)
            _close(got, want)
            assert torch.equal(got, kern(plan)), (role, plan)
    assert timed >= 5          # the depthwise conv's forward has one plan


def test_tuning_from_inside_backward(tuned):
    """The grad roles are first planned on the autograd engine's thread,
    mid-backward: their candidates are timed there (CUDA-graph capture),
    none fails, and the grads agree with lax."""
    from repro_torch.kernels import autotune
    x_shape, w_shape = (8, 12, 10, 10), (20, 12, 3, 3)
    spec = ConvSpec.make(stride=2, padding=1)
    gen = torch.Generator().manual_seed(22)
    x0 = _randn(gen, *x_shape, dev="cuda")
    w0 = _randn(gen, *w_shape, dev="cuda")
    out = {}
    for policy in ("pallas", "lax"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = tconv.conv2d(x, w, spec, policy)
        if policy == "pallas":
            assert ops.plan_events() == {"forward_autotune_miss": 1}
        y.square().sum().backward()
        out[policy] = (y.detach(), x.grad, w.grad)
    assert ops.plan_events() == {f"{r}_autotune_miss": 1
                                 for r in ops.PLAN_ROLES}
    assert all(p.autotuned and p.measured_us > 0
               for p in autotune._MEMO.values())
    for a, b in zip(out["pallas"], out["lax"]):
        _close(a, b)


def test_a_cached_process_is_served_only_hits(tuned):
    """A process with autotune=cached over the plan cache a measure run
    wrote times nothing and serves every plan from it, computing the same
    bits."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    code = (
        "import json, sys, torch\n"
        "from repro_torch.core import conv\n"
        "from repro_torch.core.convspec import ConvSpec\n"
        "from repro_torch.kernels import ops\n"
        "g = torch.Generator().manual_seed(23)\n"
        "x = torch.randn(8, 12, 10, 10, generator=g).cuda()"
        ".requires_grad_(True)\n"
        "w = torch.randn(20, 12, 3, 3, generator=g).cuda()"
        ".requires_grad_(True)\n"
        "y = conv.conv2d(x, w, ConvSpec.make(stride=2, padding=1), "
        "'pallas')\n"
        "y.square().sum().backward()\n"
        "torch.save([y.detach().cpu(), x.grad.cpu(), w.grad.cpu()], "
        "sys.argv[1])\n"
        "print(json.dumps(ops.plan_events()))\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "REPRO_PLAN_CACHE_DIR": str(tuned)}
    events = {}
    for mode in ("measure", "cached"):
        proc = subprocess.run(
            [sys.executable, "-c", code, str(tuned / f"{mode}.pt")],
            env={**env, "REPRO_AUTOTUNE": mode}, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        events[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert events["measure"] == {f"{r}_autotune_miss": 1
                                 for r in ops.PLAN_ROLES}
    assert events["cached"] == {f"{r}_autotune_hit": 1
                                for r in ops.PLAN_ROLES}
    a = torch.load(tuned / "measure.pt")
    b = torch.load(tuned / "cached.pt")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


#: bf16 operands: the kernel and its plain version read the same bf16
#: values and sum their (exact) float32 products in other orders; the
#: forward's and the input grad's outputs are then rounded to bf16 on both
#: sides (2^-8 relative), so an element may land one bf16 step apart.
#: The weight grad's output is float32 and keeps REL_TOL.
BF16_REL_TOL = 1e-2

#: Mamba2-370M's depthwise causal conv (d_inner + 2 ssm_state = 2,304
#: groups of one channel, 4 taps, left pad 3) at a short sequence, and
#: Table II layer 3's geometry cast to bf16 in 2 groups.
BF16_GEOMS = [
    (ConvDims(B=2, C=1, H_i=1, W_i=100, N=1, K_h=1, K_w=4, S=1, P_h=0,
              P_w=3, P_h_hi=0, P_w_hi=0), 2304),
    (ConvDims(B=2, C=32, H_i=56, W_i=56, N=64, K_h=3, K_w=3, S=2, P_h=1,
              P_w=1), 2),
]


def _close_rel(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1e-6), err


@pytest.mark.parametrize("d,g", BF16_GEOMS, ids=["mamba2_dw", "g2s2"])
def test_tap_kernels_bf16_instances_match_plain_versions(cuda, d, g):
    """The bf16 instances of all three kernels at the depthwise geometry
    and a grouped strided layer: the forward and the input grad return
    bf16, the weight grad float32; one launch a call, bit-equal runs."""
    gen = torch.Generator().manual_seed(31)
    x = _randn(gen, d.B, d.C * g, d.H_i, d.W_i, dev=cuda).bfloat16()
    w = _randn(gen, d.N * g, d.C, d.K_h, d.K_w, dev=cuda).bfloat16()
    dy = _randn(gen, d.B, d.N * g, d.H_o, d.W_o, dev=cuda).bfloat16()
    src, wt, taps = ops.forward_operands(x, w, d, g)
    gsrc, ws, pp = ops.input_grad_operands(dy, w, d, g)
    wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
    calls = [
        ("tap_gemm", lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
         ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o), torch.bfloat16,
         BF16_REL_TOL),
        ("tap_gemm_phased", lambda: tg.tap_gemm_phased(
            gsrc, ws, pp.phase_taps, pp.n_qh, pp.n_qw),
         ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps, pp.n_qh, pp.n_qw),
         torch.bfloat16, BF16_REL_TOL),
        ("tap_wgrad", lambda: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o),
         ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o), torch.float32,
         REL_TOL)]
    for name, kern, want, dtype, tol in calls:
        reset_launch_counts()
        got = kern()
        assert launch_counts()[name] == 1 and got.dtype == dtype, name
        _close_rel(got, want, tol)
        assert torch.equal(got, kern()), name


def test_depthwise_causal_conv1d_bf16_pallas_matches_lax(cuda):
    """Mamba2's conv through ``depthwise_causal_conv1d`` under ``pallas``
    in bf16: one launch of each tap kernel, y and both grads within bf16
    rounding of the library conv (``lax``) on the same bf16 inputs."""
    from repro_torch.core.conv import depthwise_causal_conv1d
    gen = torch.Generator().manual_seed(32)
    x0 = _randn(gen, 2, 64, 2304, dev=cuda).bfloat16()
    w0 = (0.2 * _randn(gen, 4, 2304, dev=cuda)).bfloat16()
    dy = _randn(gen, 2, 64, 2304, dev=cuda).bfloat16()
    out = {}
    for policy in ("pallas", "lax"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        reset_launch_counts()
        y = depthwise_causal_conv1d(x, w, policy)
        y.backward(dy)
        out[policy] = (y.detach(), x.grad, w.grad, launch_counts())
    for a, b in zip(out["pallas"][:3], out["lax"][:3]):
        _close_rel(a, b, 2e-2)
    assert {k: out["pallas"][3][k] for k in tg.LAUNCHES} == {
        "tap_gemm": 1, "tap_gemm_phased": 1, "tap_wgrad": 1}
    assert not any(out["lax"][3].values())


def test_tap_wrappers_raise_on_mixed_operand_types(cuda):
    src = torch.zeros(1, 1, 4, 4, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(TypeError, match="one type"):
        tg.tap_gemm(src, w, [(0, 0, 0)], 3, 3)
    with pytest.raises(TypeError, match="one type"):
        tg.tap_wgrad(src, torch.zeros(1, 3, 3, 8, device=cuda),
                     [(0, 0, 0)], 3, 3)
    with pytest.raises(TypeError, match="one type"):
        tg.tap_gemm_phased(src[0], w[None], [((0, 0, 0),)], 3, 3)


def test_a_plan_past_the_grid_z_limit_is_refused(cuda):
    """At Mamba2's 2,304 groups, 32 weight-grad splits would put 73,728
    blocks on the grid's z: the wrapper refuses that plan, and no
    candidate the tuner offers breaches the limit."""
    d = ConvDims(B=8, C=1, H_i=1, W_i=512, N=1, K_h=1, K_w=4, S=1, P_h=0,
                 P_w=3, P_h_hi=0, P_w_hi=0)
    g = 2304
    gen = torch.Generator().manual_seed(33)
    x = _randn(gen, d.B, g, 1, d.W_i, dev=cuda).bfloat16()
    dy = _randn(gen, d.B, g, 1, d.W_o, dev=cuda).bfloat16()
    src, dyn, taps = ops.weight_grad_operands(x, dy, d, g)
    with pytest.raises(ValueError, match="grid z"):
        tg.tap_wgrad(src, dyn, taps, d.H_o, d.W_o,
                     tg.Plan("weight_grad", "64x16", 32))
    for role in ops.PLAN_ROLES:
        for plan in ops.plan_candidates(role, d, g, k=100, device=cuda,
                                        dtype=torch.bfloat16):
            prob = ops.problem(role, d, g, torch.bfloat16)
            # the depthwise variant keeps the groups on the grid's x
            z = (0 if plan.variant == "dw" else plan.splits
                 if role != "input_grad" else len(tg.phased_work(
                     prob.counts, prob.cin, plan.splits,
                     tg.PHASED_TILES[plan.variant].step)[0]))
            assert z * g <= tg.GRID_YZ_MAX, (role, plan)


def test_float32_and_bf16_plans_are_tuned_apart(tuned):
    """One geometry planned for float32 and for bf16 operands: two plan
    cache entries, each timed on its own instance."""
    import json
    from repro_torch.kernels import autotune
    d = BF16_GEOMS[1][0]
    for dtype in (torch.float32, torch.bfloat16):
        plan = ops.pass_plan("forward", d, 2, "cuda", dtype)
        assert plan.autotuned and plan.cache == "miss"
    store = json.loads(open(autotune.cache_path()).read())
    keys = sorted(store["entries"])
    assert len(keys) == 2
    assert [k.rsplit("|", 1)[1] for k in keys] == ["dtype=bf16",
                                                   "dtype=f32"]
    assert ops.plan_events() == {"forward_autotune_miss": 2}


# ---------------------------------------------------------------------------
# The depthwise variant "dw" of the forward and the weight grad
# ---------------------------------------------------------------------------

def _mamba2_dims(b: int, length: int) -> ConvDims:
    """Mamba2's depthwise causal conv: one channel a group, 4 taps on an
    H = 1 plane, left pad 3."""
    return ConvDims(B=b, C=1, H_i=1, W_i=length, N=1, K_h=1, K_w=4, S=1,
                    P_h=0, P_w=3, P_h_hi=0, P_w_hi=0)


_S2 = ConvDims(B=2, C=1, H_i=17, W_i=17, N=1, K_h=3, K_w=3, S=2, P_h=1,
               P_w=1)

#: (label, per-group dims, groups, operand type): Mamba2's geometry
#: (BF16_GEOMS) and its training shape, ragged lengths (rows of 103 and
#: 1,004 elements: most windows and stores off a 16-byte boundary), the
#: CNN's 3 x 3 in 16 groups (float32), a stride-2 3 x 3 (taps on 4 phase
#: planes) in both types, a 7 x 7 (the 49-tap instance), and 4,096 and
#: 70,000 groups (past the tiles' grid z).
DW_CASES = [
    ("mamba2 W100 bf16", BF16_GEOMS[0][0], 2304, torch.bfloat16),
    ("mamba2 8x512 bf16", _mamba2_dims(8, 512), 2304, torch.bfloat16),
    ("ragged W1001 bf16", _mamba2_dims(2, 1001), 256, torch.bfloat16),
    ("cnn 3x3 g16 f32", ConvDims(B=32, C=1, H_i=8, W_i=8, N=1, K_h=3, K_w=3,
                                 S=1, P_h=1, P_w=1), 16, torch.float32),
    ("s2 3x3 bf16", _S2, 24, torch.bfloat16),
    ("s2 3x3 f32", _S2, 24, torch.float32),
    ("7x7 f32", ConvDims(B=2, C=1, H_i=14, W_i=14, N=1, K_h=7, K_w=7, S=1,
                         P_h=3, P_w=3), 8, torch.float32),
    ("g4096 bf16", _mamba2_dims(2, 64), 4096, torch.bfloat16),
    ("g70000 bf16", _mamba2_dims(1, 40), 70_000, torch.bfloat16),
]


def _dw_operands(d, g, dtype, dev, seed=41):
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, d.B, g, d.H_i, d.W_i, dev=dev).to(dtype)
    w = _randn(gen, g, 1, d.K_h, d.K_w, dev=dev).to(dtype)
    dy = _randn(gen, d.B, g, d.H_o, d.W_o, dev=dev).to(dtype)
    src, wt, taps = ops.forward_operands(x, w, d, g)
    wsrc, dyn, wtaps = ops.weight_grad_operands(x, dy, d, g)
    return src, wt, taps, wsrc, dyn, wtaps


#: the dw input grad in float32 against its plain version: fmaf rounds
#: each tap's product and sum once, the plain version twice.
DW_F32_TOL = 1e-6


@pytest.mark.parametrize("label,d,g,dtype", DW_CASES,
                         ids=[c[0] for c in DW_CASES])
def test_dw_variant_matches_plain_versions(cuda, label, d, g, dtype):
    """The analytic plans of a depthwise forward, input grad and weight
    grad are the dw variant; each call is one dw launch, within bf16
    rounding (the forward's and the input grad's bf16 output), REL_TOL (the
    input grad in float32: ``DW_F32_TOL``) of the plain version, and
    bit-equal run to run."""
    src, wt, taps, wsrc, dyn, wtaps = _dw_operands(d, g, dtype, cuda)
    gen = torch.Generator().manual_seed(45)
    gsrc, ws, pp = ops.input_grad_operands(
        _randn(gen, d.B, g, d.H_o, d.W_o, dev=cuda).to(dtype),
        _randn(gen, g, 1, d.K_h, d.K_w, dev=cuda).to(dtype), d, g)
    bf16 = dtype == torch.bfloat16
    calls = [
        ("tap_gemm", "forward",
         lambda: tg.tap_gemm(src, wt, taps, d.H_o, d.W_o),
         ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o),
         BF16_REL_TOL if bf16 else REL_TOL),
        ("tap_gemm_phased", "input_grad",
         lambda: tg.tap_gemm_phased(gsrc, ws, pp.phase_taps, pp.n_qh,
                                    pp.n_qw),
         ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps, pp.n_qh, pp.n_qw),
         BF16_REL_TOL if bf16 else DW_F32_TOL),
        ("tap_wgrad", "weight_grad",
         lambda: tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o),
         ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o), REL_TOL)]
    for name, role, kern, want, tol in calls:
        assert ops.pass_plan(role, d, g, cuda, dtype).variant == "dw"
        reset_launch_counts()
        got = kern()
        assert launch_counts()[name] == 1, name
        assert tg.variant_launch_counts() == {f"{name}:dw": 1}
        _close_rel(got, want, tol)
        assert torch.equal(got, kern()), name


def test_dw_variant_takes_operands_off_a_16_byte_boundary(cuda):
    """Mamba2's geometry in bf16 with every operand a contiguous view 2
    bytes past a 16-byte boundary: the windows take the address-aligned
    vector path or the masked one, and both passes equal the aligned
    operands' results bit for bit."""
    d, g = BF16_GEOMS[0]
    src, wt, taps, wsrc, dyn, wtaps = _dw_operands(d, g, torch.bfloat16,
                                                   cuda, seed=42)

    def shifted(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 2
        return view

    y = tg.tap_gemm(src, wt, taps, d.H_o, d.W_o)
    dw = tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o)
    reset_launch_counts()
    assert torch.equal(tg.tap_gemm(shifted(src), shifted(wt), taps, d.H_o,
                                   d.W_o), y)
    assert torch.equal(tg.tap_wgrad(shifted(wsrc), shifted(dyn), wtaps,
                                    d.H_o, d.W_o), dw)
    assert tg.variant_launch_counts() == {"tap_gemm:dw": 1,
                                          "tap_wgrad:dw": 1}
    _close_rel(y, ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o),
               BF16_REL_TOL)


def test_tiles_still_match_plain_versions_at_the_depthwise_geometry(cuda):
    """The tiles the depthwise variant replaces, given as explicit plans,
    still run Mamba2's geometry in bf16 and match the plain versions."""
    d, g = BF16_GEOMS[0]
    src, wt, taps, wsrc, dyn, wtaps = _dw_operands(d, g, torch.bfloat16,
                                                   cuda, seed=43)
    gen = torch.Generator().manual_seed(48)
    gsrc, ws, pp = ops.input_grad_operands(
        _randn(gen, d.B, g, d.H_o, d.W_o, dev=cuda).bfloat16(),
        _randn(gen, g, 1, d.K_h, d.K_w, dev=cuda).bfloat16(), d, g)
    counts = [len(t) for t in pp.phase_taps]
    want = ref.tap_gemm_phased_ref(gsrc, ws, pp.phase_taps, pp.n_qh, pp.n_qw)
    for variant in ("128x8", "64x16", "64x64"):
        plan = tg.Plan("input_grad", *tg.phased_plan(
            g, counts, 1, 1, d.B * pp.n_qh * pp.n_qw, 132, variant))
        reset_launch_counts()
        _close_rel(tg.tap_gemm_phased(gsrc, ws, pp.phase_taps, pp.n_qh,
                                      pp.n_qw, plan), want, BF16_REL_TOL)
        assert tg.variant_launch_counts() == {
            f"tap_gemm_phased:{variant}": 1}
    rows = d.B * d.H_o * d.W_o
    y_want = ref.tap_gemm_ref(src, wt, taps, d.H_o, d.W_o)
    dw_want = ref.tap_wgrad_ref(wsrc, dyn, wtaps, d.H_o, d.W_o)
    for variant in ("64x16", "64x64"):
        plan = tg.Plan("weight_grad", *tg.wgrad_plan(g, len(wtaps), 1, 1,
                                                     rows, 132, variant))
        reset_launch_counts()
        _close_rel(tg.tap_wgrad(wsrc, dyn, wtaps, d.H_o, d.W_o, plan),
                   dw_want, REL_TOL)
        assert tg.variant_launch_counts() == {f"tap_wgrad:{variant}": 1}
    reset_launch_counts()
    _close_rel(tg.tap_gemm(src, wt, taps, d.H_o, d.W_o,
                           tg.Plan("forward", "64x64", 1)), y_want,
               BF16_REL_TOL)
    assert tg.variant_launch_counts() == {"tap_gemm:64x64": 1}


def test_depthwise_causal_conv1d_runs_dw_for_forward_and_weight_grad(cuda):
    """Mamba2's conv under ``pallas`` in bf16: the forward, the input grad
    and the weight grad launch the dw variant once each."""
    from repro_torch.core.conv import depthwise_causal_conv1d
    gen = torch.Generator().manual_seed(44)
    x = _randn(gen, 2, 64, 2304, dev=cuda).bfloat16().requires_grad_(True)
    w = (0.2 * _randn(gen, 4, 2304, dev=cuda)).bfloat16().requires_grad_(True)
    reset_launch_counts()
    depthwise_causal_conv1d(x, w, "pallas").backward(
        _randn(gen, 2, 64, 2304, dev=cuda).bfloat16())
    assert tg.variant_launch_counts() == {"tap_gemm:dw": 1,
                                          "tap_gemm_phased:dw": 1,
                                          "tap_wgrad:dw": 1}


#: depthwise input grads whose phases differ, as (label, per-group dims,
#: groups): a 3 x 3 at stride 2 (phases of 1, 2, 2 and 4 taps), a 7 x 7 at
#: stride 2 (49 taps over 4 phases: the 49-row table), a (2, 3) stride with
#: dilation 2 (four of six phases without taps), and K = 2 at stride 3
#: (five of nine).
DW_GRAD_CASES = [
    ("3x3 s2", _S2, 24),
    ("7x7 s2", ConvDims(B=2, C=1, H_i=28, W_i=28, N=1, K_h=7, K_w=7, S=2,
                        P_h=3, P_w=3), 8),
    ("s2x3 d2", ConvDims(B=2, C=1, H_i=13, W_i=14, N=1, K_h=3, K_w=3, S=2,
                         S_w=3, P_h=2, P_w=2, D_h=2, D_w=2), 12),
    ("k2 s3", ConvDims(B=2, C=1, H_i=10, W_i=10, N=1, K_h=2, K_w=2, S=3),
     12),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("label,d,g", DW_GRAD_CASES,
                         ids=[c[0] for c in DW_GRAD_CASES])
def test_dw_input_grad_matches_plain_version_at_every_phase_shape(
        cuda, label, d, g, dtype):
    """The dw input grad where its phases run different tap counts or
    none: one launch, within ``DW_F32_TOL`` (float32) or bf16 rounding of
    the plain version, bit-equal run to run, and every phase without taps
    written to zeros over an output buffer the allocator last held as
    NaNs (the kernel stores them: the output is ``torch.empty``)."""
    gen = torch.Generator().manual_seed(46)
    dy = _randn(gen, d.B, g, d.H_o, d.W_o, dev=cuda).to(dtype)
    w = _randn(gen, g, 1, d.k_taps_h, d.k_taps_w, dev=cuda).to(dtype)
    src, ws, pp = ops.input_grad_operands(dy, w, d, g)
    counts = [len(t) for t in pp.phase_taps]
    assert ops.pass_plan("input_grad", d, g, cuda, dtype) == tg.Plan(
        "input_grad", "dw", 1)
    want = ref.tap_gemm_phased_ref(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw)
    junk = torch.full_like(want, float("nan"))
    del junk
    reset_launch_counts()
    got = tg.tap_gemm_phased(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw)
    assert tg.variant_launch_counts() == {"tap_gemm_phased:dw": 1}
    _close_rel(got, want, BF16_REL_TOL if dtype == torch.bfloat16
               else DW_F32_TOL)
    for p, n in enumerate(counts):
        if n == 0:
            assert not got[:, p].any(), p
    assert torch.equal(got, tg.tap_gemm_phased(src, ws, pp.phase_taps,
                                               pp.n_qh, pp.n_qw))


@pytest.mark.parametrize("length", range(97, 104))
def test_dw_input_grad_takes_rows_misaligned_by_1_to_7_elements(cuda,
                                                                length):
    """Mamba2's geometry in bf16 at lengths 97-103: dY rows of 1-7
    elements past a 16-byte multiple, so most windows and stores are off a
    16-byte boundary and the causal taps run past each row's end; within
    bf16 rounding of the plain version, and with dY and the weights each a
    view 2 bytes past a 16-byte boundary, equal bit for bit."""
    d, g = _mamba2_dims(2, length), 64
    gen = torch.Generator().manual_seed(47)
    dy = _randn(gen, d.B, g, d.H_o, d.W_o, dev=cuda).bfloat16()
    w = _randn(gen, g, 1, d.K_h, d.K_w, dev=cuda).bfloat16()
    src, ws, pp = ops.input_grad_operands(dy, w, d, g)
    assert src.shape[-2] % 8 == length % 8 != 0

    def shifted(t):
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 2
        return view

    reset_launch_counts()
    got = tg.tap_gemm_phased(src, ws, pp.phase_taps, pp.n_qh, pp.n_qw)
    _close_rel(got, ref.tap_gemm_phased_ref(src, ws, pp.phase_taps, pp.n_qh,
                                            pp.n_qw), BF16_REL_TOL)
    assert torch.equal(tg.tap_gemm_phased(shifted(src), shifted(ws),
                                          pp.phase_taps, pp.n_qh, pp.n_qw),
                       got)
    assert tg.variant_launch_counts() == {"tap_gemm_phased:dw": 2}


# ---------------------------------------------------------------------------
# Fault injection and runtime degradation on the card (ROADMAP A12)
# ---------------------------------------------------------------------------

@pytest.fixture
def armed():
    """The port's config restored, the injector's clock at 0 and every
    introspection surface clean, before and after."""
    from repro_torch import obs
    from repro_torch.core.config import config
    from repro_torch.ft import inject
    saved = config.snapshot()
    obs.reset_all()
    inject.set_step(0)
    yield config
    config.update(**saved)
    inject.set_step(0)
    obs.reset_all()


def test_a_faulted_kernel_pass_degrades_and_launches_nothing(cuda, armed):
    """``pallas.forward.launch`` faulted on a CUDA conv: the pass re-runs
    on ``bp_phase``, equal to the unarmed kernel's output within
    ``REL_TOL``, and the faulted pass launches no tap kernel."""
    gen = torch.Generator().manual_seed(0)
    x, w = _randn(gen, 4, 16, 17, 17, dev=cuda), _randn(gen, 32, 16, 3, 3,
                                                       dev=cuda)
    spec = ConvSpec.make(stride=2, padding=1)
    reset_launch_counts()
    want = tconv.conv2d(x, w, spec, "pallas")
    assert launch_counts()["tap_gemm"] == 1
    armed.update(fault_spec="pallas.forward.launch:raise")
    reset_launch_counts()
    got = tconv.conv2d(x, w, spec, "pallas")
    assert not any(launch_counts().values())
    _close(got, want)
    ev = tconv.dispatch_events()
    assert ev["forward:pallas->bp_phase"] == 1 and ev["forward:bp_phase"] == 1
    assert tconv.runtime_failures()[0]["exception"] == "InjectedFault"


def test_a_probe_relaunches_the_kernel(cuda, armed, monkeypatch):
    """Faulted at step 0, quarantined at step 1, probed at step 2: the
    probe launches the kernel again and lifts the quarantine; every
    output matches the kernel's."""
    from repro_torch.ft import inject
    monkeypatch.setattr(tconv, "QUARANTINE_PROBE_AFTER", 1)
    gen = torch.Generator().manual_seed(1)
    x = _randn(gen, 2, 8, 12, 12, dev=cuda).requires_grad_(True)
    w = _randn(gen, 16, 8, 3, 3, dev=cuda).requires_grad_(True)
    spec = ConvSpec.make(stride=2, padding=1)
    y = tconv.conv2d(x, w, spec, "pallas")
    want = torch.autograd.grad(y.square().sum(), [x, w])
    armed.update(fault_spec="pallas.*:raise@step0")
    launches = []
    for step in range(3):
        inject.set_step(step)
        reset_launch_counts()
        y = tconv.conv2d(x, w, spec, "pallas")
        got = torch.autograd.grad(y.square().sum(), [x, w])
        launches.append(launch_counts())
        for g, t in zip(got, want):
            _close(g, t)
    taps = ("tap_gemm", "tap_gemm_phased", "tap_wgrad")
    assert [[c[k] for k in taps] for c in launches] == \
        [[0, 0, 0], [0, 0, 0], [1, 1, 1]]
    ev = tconv.dispatch_events()
    for p in ("forward", "input_grad", "weight_grad"):
        assert ev[f"{p}:pallas:probe"] == ev[f"{p}:pallas:recovered"] == 1
    assert not tconv.quarantined_engines()


def test_a_decode_fault_fails_only_its_lanes_on_the_card(cuda, armed):
    """SmolLM-360M's smoke config on the card, continuous engine, 2 lanes:
    ``serve.decode:raise@step2`` fails the two requests of decode step 2
    (the unarmed run's first 2 tokens kept); the other two end ``ok`` with
    the unarmed run's tokens; flash launched once a layer per request."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.request import Request
    cfg = get_smoke_config("smollm-360m")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)

    def run():
        reset_launch_counts()
        eng = ContinuousEngine(cfg, params, max_batch=2, max_len=40)
        for rid in range(4):
            prompt = torch.randint(1, cfg.vocab, (20,), generator=torch
                                   .Generator().manual_seed(rid)).tolist()
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        done = {r.rid: r for r in eng.run()}
        return done, eng.run_summary(), launch_counts()["flash_attention"]

    want, _, _ = run()
    armed.update(fault_spec="serve.decode:raise@step2")
    got, summary, flash = run()
    assert [got[r].status for r in range(4)] == ["failed", "failed", "ok",
                                                 "ok"]
    assert all(got[r].out == want[r].out[:2] for r in (0, 1))
    assert all(got[r].out == want[r].out for r in (2, 3))
    assert summary["failed"] == 2 and summary["admitted"] == 4
    assert flash == cfg.n_layers * 4


def test_a_kernel_that_fails_on_the_card_fails_the_call(cuda, armed,
                                                       monkeypatch):
    """A tap-kernel wrapper that raises anything but an injected fault
    (here a refused launch) fails the conv on the card: no engine serves
    the pass in its place, and nothing is recorded or quarantined."""
    from repro_torch.kernels import ops

    def refused(*a, **k):
        raise RuntimeError("tap_gemm: CUDA launch failed")

    monkeypatch.setattr(ops, "conv2d_forward", refused)
    gen = torch.Generator().manual_seed(2)
    x, w = _randn(gen, 2, 8, 12, 12, dev=cuda), _randn(gen, 16, 8, 3, 3,
                                                      dev=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        tconv.conv2d(x, w, ConvSpec.make(stride=2, padding=1), "pallas")
    assert tconv.runtime_failures() == []
    assert tconv.quarantined_engines() == []
    assert tconv.dispatch_events() == {}


def test_a_prefill_that_fails_on_the_card_fails_the_run(cuda, armed,
                                                       monkeypatch):
    """On the card a prefill that raises anything but an injected fault
    escapes the continuous engine's ``run`` instead of being reported as
    a failed request."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve.continuous import ContinuousEngine
    from repro_torch.serve.request import Request
    cfg = get_smoke_config("smollm-360m")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, cuda)

    def refused(*a, **k):
        raise RuntimeError("flash_attention: CUDA launch failed")

    monkeypatch.setattr(M, "prefill", refused)
    eng = ContinuousEngine(cfg, params, max_batch=2, max_len=16)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=4))
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.run()
    assert eng.counters["failed"] == 0 and eng.counters["admitted"] == 0
