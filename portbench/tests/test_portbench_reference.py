"""The plain references against independent computations at tiny sizes,
and the imports of everything the benchmark runs."""

from __future__ import annotations

import ast
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.lib import lmwork, precision
from portbench.lib import mamba2_params as MP
from portbench.reference import conv as ref_conv
from portbench.reference import mamba2 as ref_lm
from portbench.tests import _tiny

PB = pathlib.Path(__file__).resolve().parents[1]


def _conv_np(x, w, s, p):
    """Direct loops in float64: y[b, n, i, j] = sum x_pad * w."""
    b, c, h, _ = x.shape
    n, _, k, _ = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)))
    ho = (h + 2 * p - k) // s + 1
    y = np.zeros((b, n, ho, ho))
    for i in range(ho):
        for j in range(ho):
            patch = xp[:, :, i * s:i * s + k, j * s:j * s + k]
            y[:, :, i, j] = np.einsum("bckl,nckl->bn", patch, w)
    return y


@pytest.mark.parametrize("layer", _tiny.CONV_LAYERS, ids=lambda la: la["name"])
def test_conv_reference_against_direct_loops(layer):
    g = torch.Generator().manual_seed(3)
    s, p, k = layer["S"], layer["P"], layer["K"]
    x = torch.randn(2, layer["C"], layer["H"], layer["H"], generator=g)
    w = torch.randn(layer["N"], layer["C"], k, k, generator=g)
    y0 = _conv_np(x.double().numpy(), w.double().numpy(), s, p)
    dy = torch.randn(*y0.shape, generator=g)
    y, dx, dw = ref_conv.passes(x, w, dy, s, p)
    np.testing.assert_allclose(y.numpy(), y0, rtol=1e-5, atol=1e-4)
    # The grads by their definitions: <dy, conv(x, w)> is linear in x and
    # in w, so its gradient in each is the other pass.
    xd = x.double().requires_grad_(True)
    wd = w.double().requires_grad_(True)
    (F.conv2d(xd, wd, stride=s, padding=p) * dy.double()).sum().backward()
    np.testing.assert_allclose(dx.numpy(), xd.grad.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), wd.grad.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_the_control_rounds_to_tf32_and_e4m3():
    t = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -12,
                      -1.0 - 2 ** -4, 1.0 + 2 ** -5])
    got = precision.round_mantissa(t, precision.BITS["tf32"])
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                            -1.0 - 2 ** -4, 1.0 + 2 ** -5]
    got = precision.round_mantissa(t, precision.BITS["e4m3"])
    assert got.tolist() == [1.0, 1.0, 1.0, -1.0 - 2 ** -3, 1.0]


def _ssd_scan(x, dt, A, B, C):
    """The SSD recurrence one position at a time, in float64."""
    b, l, h, p = x.shape
    s = torch.zeros(b, h, p, B.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(l):
        a = torch.exp(dt[:, t] * A)                         # (b, h)
        s = s * a[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t]))
    return torch.stack(ys, 1)


def test_the_chunked_ssd_against_a_sequential_scan():
    g = torch.Generator().manual_seed(4)
    b, l, h, p, n = 2, 96, 3, 4, 5
    x = torch.randn(b, l, h, p, generator=g, dtype=torch.float64)
    dt = F.softplus(torch.randn(b, l, h, generator=g, dtype=torch.float64))
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 4
    B = torch.randn(b, l, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, l, n, generator=g, dtype=torch.float64)
    want = _ssd_scan(x, dt, A, B, C)
    for chunk in (16, 32, 96):
        got = ref_lm.ssd(x, dt, A, B, C, chunk=chunk)
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def test_the_causal_depthwise_conv_against_conv1d():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 11, 6, generator=g)
    w = torch.randn(4, 6, generator=g)
    want = F.conv1d(F.pad(x.transpose(1, 2), (3, 0)), w.T[:, None, :],
                    groups=6).transpose(1, 2)
    torch.testing.assert_close(ref_lm.causal_dwconv(x, w), want)


def _loss_by_scan(p, tokens, targets, sizes, eps):
    """The Mamba2 LM's loss written out position by position in float64:
    no chunks, no blocks, no recomputation."""
    di, ds, h = sizes["d_inner"], sizes["d_state"], sizes["heads"]
    x = p["embed/w"][tokens]
    for i in range(sizes["layers"]):
        lp = {k.split("/")[-2]: p[k][i] for k in ref_lm._LAYER_LEAVES}
        u = ref_lm.rmsnorm(x, p["blocks/ln/scale"][i], eps) @ lp["in_proj"]
        z, xs, Bm, Cm, dt = torch.split(u, [di, di, ds, ds, h], dim=-1)
        xbc = torch.cat([xs, Bm, Cm], -1)
        k = lp["conv_w"].shape[0]
        xbc = F.silu(torch.stack([
            sum(lp["conv_w"][j] * xbc[:, t + j - k + 1]
                for j in range(k) if t + j - k + 1 >= 0)
            for t in range(xbc.shape[1])], 1))
        xs, Bm, Cm = torch.split(xbc, [di, ds, ds], dim=-1)
        dt = F.softplus(dt + lp["dt_bias"])
        xh = xs.reshape(*xs.shape[:2], h, di // h)
        y = _ssd_scan(xh, dt, -torch.exp(lp["a_log"]), Bm, Cm)
        y = (y + xh * lp["d_skip"][:, None]).reshape(*xs.shape[:2], di)
        y = ref_lm.rmsnorm(y * F.silu(z), p["blocks/ssm/norm/scale"][i],
                           sizes["gated_norm_eps"])
        x = x + y @ lp["out_proj"]
    logits = ref_lm.rmsnorm(x, p["final_norm/scale"], eps) @ p["embed/w"].T
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold + ref_lm.Z_LOSS * logz * logz).mean()


def _tiny_lm(seed=6):
    cfg = _tiny.cell("mamba2-370m-nobias-bf16res.train-8x2048").config
    sizes = lmwork.mamba2_sizes(cfg)
    params = MP.make(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg["vocab_size"], (2, 65), generator=g)
    return cfg, sizes, params, ids[:, :-1], ids[:, 1:]


def test_the_lm_loss_against_a_position_by_position_model():
    cfg, sizes, params, tokens, targets = _tiny_lm()
    p64 = {k: v.double() for k, v in params.items()}
    want = _loss_by_scan(p64, tokens, targets, sizes, cfg["norm_eps"])
    p32 = {k: v.float() for k, v in params.items()}
    got = ref_lm.loss(p32, tokens, targets, sizes, cfg["norm_eps"])
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))


def test_one_adamw_step_of_the_reference_by_hand():
    cfg, sizes, params, tokens, targets = _tiny_lm(7)
    opt = cfg["optimizer"]
    tr = ref_lm.Trainer(params, sizes, cfg["norm_eps"], opt)
    tr.step(tokens, targets)
    leaves = {k: v.float().requires_grad_(True) for k, v in params.items()}
    loss = ref_lm.loss(leaves, tokens, targets, sizes, cfg["norm_eps"])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / norm)
    lr = ref_lm.lr_at(1, opt)
    for k, g in grads.items():
        g = g * scale
        # After one step m / (1 - b1) = g and v / (1 - b2) = g^2.
        upd = g / (g.abs() + opt["eps"]) + opt["weight_decay"] \
            * params[k].float()
        want = (params[k].float() - lr * upd).to(params[k].dtype)
        assert torch.equal(tr.stored[k], want), k
        assert abs(tr.first[k] - float(torch.linalg.vector_norm(g))) \
            <= 1e-6 * max(tr.first[k], 1e-12)


def _imports(path: pathlib.Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module)
    return out


def _top(names) -> set[str]:
    return {n.split(".", 1)[0] for n in names}


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not _top(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}, \
            path


def test_the_reference_imports_nothing_of_the_program():
    seen, todo = set(), [PB / "reference"]
    files = [p for d in todo for p in d.rglob("*.py")]
    while files:
        path = files.pop()
        if path in seen:
            continue
        seen.add(path)
        names = _imports(path)
        assert not _top(names) & {"repro_torch", "repro", "jax"}, path
        for n in names:
            if n.startswith("portbench."):
                mod = PB.parent / (n.replace(".", "/") + ".py")
                if mod.exists():
                    files.append(mod)


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from portbench import run\n"
            "from portbench.lib import result\n"
            "from portbench.tests import _tiny\n"
            "for name in ('resnet50-s2convs.b256', "
            "'mamba2-370m-nobias-bf16res.train-8x2048'):\n"
            "    run.run_cell(_tiny.cell(name), 3, 0.1, True, 'cpu')\n"
            "print(result.forbidden_modules())\n")
    root = PB.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from portbench.lib import result
    mods = {"repro_torch": 1, "repro_torch.core": 1, "repro": 1,
            "repro.core": 1, "jaxtyping": 1, "jax.numpy": 1, "flax": 1}
    assert result.forbidden_modules(mods) == ["flax", "jax.numpy", "repro",
                                              "repro.core"]
