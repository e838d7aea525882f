"""The port's flash attention against the JAX package on the CPU: the plain
version (``repro_torch.kernels.ref.flash_attention_ref``, which the wrapper
returns for CPU tensors) against the Pallas ``flash_attention`` kernel in
interpret mode and against ``repro.kernels.ref.flash_attention_ref`` --
causal and full, ragged lengths, fewer queries than keys, grouped
key/value heads (against JAX on repeated K/V) and head dims up to 256 --
all within 1e-5 in float32.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The float32 kernel's accuracy premise is held here too: an emulation of
its arithmetic in torch (each operand split into two TF32 values, three
TF32 products a pair in its order, float32 sums, online softmax over its
key tiles in exp2 units) stays within 1e-5 of JAX's
``flash_attention_ref``, while the same walk with one TF32 product a pair
does not; and with each mma step rounded toward zero, as the tensor cores
round, one accumulator over a 1,000-key walk drifts past 1e-5 where the
kernel's short chains stay well inside.  The emulation runs its many
small ops on one intra-op thread: beside other test processes, a pool of
threads waking for each op costs far more than the op."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402,E501

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

TOL = 1e-5

#: (B, H, Hk, Lq, Lk, D, causal)
CASES = [
    (2, 4, 4, 128, 128, 64, True),
    (1, 2, 2, 200, 200, 32, True),       # ragged: not a multiple of a tile
    (1, 2, 2, 100, 100, 32, False),
    (1, 2, 2, 48, 160, 16, True),        # Lq < Lk: q_offset = 112
    (1, 2, 2, 1, 77, 32, True),          # one query row (decode-like)
    (1, 6, 2, 96, 96, 16, True),         # GQA: 3 query heads per KV head
    (2, 4, 1, 40, 72, 16, False),        # GQA (MQA), full attention
    # MLA's head dim (qk_nope 128 + qk_rope 64), the card's widest instance
    (1, 2, 2, 130, 130, 192, True),
    (1, 4, 2, 48, 160, 192, True),       # Lq < Lk, GQA
    # recurrentgemma-9b's head dim, one KV head (MQA): the card's widest
    (1, 4, 1, 130, 130, 256, True),
    (1, 2, 2, 100, 100, 256, False),
    (1, 4, 1, 48, 160, 256, True),       # Lq < Lk
    # hubert-xlarge's encoder: heads of 80, full attention, ragged length
    (2, 4, 4, 100, 100, 80, False),
]


def _ids(c):
    return "B{}H{}Hk{}q{}k{}D{}{}".format(*c[:6], "c" if c[6] else "f")


def _inputs(case, seed=0):
    b, h, hk, lq, lk, d, _ = case
    r = np.random.RandomState(seed)
    return (r.randn(b, h, lq, d).astype(np.float32),
            r.randn(b, hk, lk, d).astype(np.float32),
            r.randn(b, hk, lk, d).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_version_matches_pallas_kernel_and_jax_ref(case):
    q, k, v = _inputs(case)
    causal = case[6]
    g = case[1] // case[2]
    # JAX's kernel and oracle take one KV head per query head: repeat.
    kr, vr = (jnp.asarray(np.repeat(a, g, axis=1)) for a in (k, v))
    want_kernel = np.asarray(jflash(jnp.asarray(q), kr, vr, causal=causal,
                                    interpret=True))
    want_ref = np.asarray(jref.flash_attention_ref(jnp.asarray(q), kr, vr,
                                                   causal=causal))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)


def test_wrapper_on_cpu_returns_the_plain_version_and_launches_nothing():
    case = CASES[5]
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=1))
    FA.LAUNCHES["flash_attention"] = 0
    got = FA.flash_attention(q, k, v, causal=True, scale=0.3)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True,
                                                    scale=0.3))
    assert got.dtype == q.dtype and got.shape == q.shape
    assert FA.LAUNCHES == {"flash_attention": 0, "flash_attention_f32": 0}


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="without a key"):
        FA.flash_attention(q, k[:, :, :4], k[:, :, :4], causal=True)
    with pytest.raises(ValueError, match="not a multiple"):
        FA.flash_attention(q, torch.zeros(1, 3, 8, 16),
                           torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="two equal"):
        FA.flash_attention(q, k, torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError, match="no keys"):
        FA.flash_attention(q, k[:, :, :0], k[:, :, :0], causal=False)
    # Lq > Lk is fine without the causal mask.
    assert FA.flash_attention(q, k[:, :, :4], k[:, :, :4],
                              causal=False).shape == q.shape


# --- the float32 CUDA kernel's arithmetic, emulated ------------------------

LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32`` on finite values): add half of the
    dropped 13 bits' range to the bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _steps(x, y, tc_rounding: bool):
    """Every k-step's product of ``x @ y`` at once: (nk, ..., m, n), step
    s = x[..., 8s:8s+8] @ y[8s:8s+8, :], in float64 (exact for TF32
    operands) with ``tc_rounding``, else in float32.  K is zero-padded to
    a multiple of 8 (the padding adds exact zeros)."""
    pad = -x.shape[-1] % 8
    x = torch.nn.functional.pad(x, (0, pad))
    y = torch.nn.functional.pad(y, (0, 0, 0, pad))
    if tc_rounding:
        x, y = x.double(), y.double()
    xs = x.unflatten(-1, (-1, 8)).movedim(-2, 0)       # (nk, ..., m, 8)
    ys = y.unflatten(-2, (-1, 8)).movedim(-3, 0)       # (nk, ..., 8, n)
    return xs @ ys


def _chain(acc, pairs, tc_rounding: bool):
    """One accumulator through m16n8k8 steps: for each k-step of 8, in
    order, each (x, y) of ``pairs`` adds x[..., k-step] @ y[k-step, :]
    (TF32 operands, exact products).  With ``tc_rounding`` each step sums
    exactly and rounds toward zero, as the tensor cores do; else it is a
    float32 sum.  The products of every k-step and pair come from one
    batched matmul a pair (:func:`_steps`); only the sums run in order."""
    prods = [_steps(x, y, tc_rounding) for x, y in pairs]
    for k in range(prods[0].shape[0]):
        for p in prods:
            acc = (_toward_zero(acc.double() + p[k]) if tc_rounding
                   else acc + p[k])
    return acc


def _products(a, b, *, three: bool = True, tc_rounding: bool = False,
              into=None):
    """``a @ b`` as the kernel sums it: a_hi b_lo and a_lo b_hi chained
    into one accumulator, a_hi b_hi into another, both from zero, summed
    in float32 (only a_hi b_hi with ``three`` False).  With ``into`` the
    three products of every k-step chain into that one accumulator
    instead (a long chain).  a (..., m, K), b (..., K, n)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    if into is not None:
        return _chain(into, [(ah, bl), (al, bh), (ah, bh)], tc_rounding)
    zero = torch.zeros(*a.shape[:-1], b.shape[-1])
    big = _chain(zero, [(ah, bh)], tc_rounding)
    return big + _chain(zero, [(ah, bl), (al, bh)], tc_rounding) \
        if three else big


@contextlib.contextmanager
def _one_thread():
    """torch's intra-op threads set to one, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@_one_thread()
def flash_f32_emulated(q, k, v, *, causal: bool, three: bool = True,
                       tc_rounding: bool = False, short_chains: bool = True):
    """The float32 kernel's walk: Q scaled by scale * log2(e), key tiles of
    64 rows (32 at D 80 and past 128), masks, a running max and normaliser
    in float32 with exp2; S and each tile's P V as ``_products`` sums
    them, O taking the tile as o * alpha + part.  From D 128 two walks
    take half of every key tile each and merge at the end, as the
    kernel's two warps a strip do.  ``short_chains`` False chains all of
    S's products into one accumulator and every tile's P V into O
    itself.  D zero-padded to the instance's width is left out (zero
    columns add exact zeros)."""
    b, h, lq, d = q.shape
    hk, lk = k.shape[1], k.shape[2]
    dm = next(w for w in (64, 80, 128, 192, 256) if d <= w)
    bkv = 32 if dm == 80 or dm > 128 else 64
    walks = 2 if dm >= 128 else 1
    k = k.repeat_interleave(h // hk, dim=1)
    v = v.repeat_interleave(h // hk, dim=1)
    pad = -d % 8
    qs = torch.nn.functional.pad(q * (d ** -0.5 * LOG2E), (0, pad))
    kp = torch.nn.functional.pad(k, (0, pad))
    qpos = torch.arange(lq) + lk - lq
    opts = dict(three=three, tc_rounding=tc_rounding)
    runs = []
    for w in range(walks):
        m = torch.full((b, h, lq), -1e30)
        l = torch.zeros(b, h, lq)
        acc = torch.zeros(b, h, lq, d)
        for t0 in range(0, lk, bkv):
            k0 = t0 + w * bkv // walks
            if k0 >= lk:
                continue
            keys = torch.arange(k0, min(k0 + bkv // walks, lk))
            kt, vt = kp[:, :, keys], v[:, :, keys]
            zero = torch.zeros(b, h, lq, len(keys))
            s = _products(qs, kt.transpose(-1, -2), **opts,
                          into=None if short_chains else zero)
            if causal:
                s = s.masked_fill(keys[None, :] > qpos[:, None],
                                  float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            if short_chains:
                acc = acc * alpha[..., None] + _products(p, vt, **opts)
            else:
                acc = _products(p, vt, into=acc * alpha[..., None], **opts)
            m = m_new
        runs.append((m, l, acc))
    m = torch.stack([r[0] for r in runs]).amax(0)
    scales = [torch.exp2(r[0] - m) for r in runs]
    l = sum(r[1] * a for r, a in zip(runs, scales))
    acc = sum(r[2] * a[..., None] for r, a in zip(runs, scales))
    return acc / l[..., None]


#: (B, H, Hk, Lq, Lk, D, causal): hubert's head dim (the D-80 instance),
#: MLA's and recurrentgemma's, each causal and full, with grouped KV heads;
#: lengths past one key tile, ragged, and Lq < Lk.
EMULATED_CASES = [
    (1, 4, 2, 100, 100, 80, True),
    (2, 4, 2, 70, 150, 80, False),
    (1, 4, 2, 40, 100, 192, True),
    (1, 4, 2, 70, 70, 192, False),
    (1, 4, 1, 70, 70, 256, True),
    (1, 4, 1, 50, 90, 256, False),
]


def _emulated_and_jax(case):
    q, k, v = _inputs(case, seed=2)
    causal = case[6]
    g = case[1] // case[2]
    kr, vr = (jnp.asarray(np.repeat(a, g, axis=1)) for a in (k, v))
    want = np.asarray(jref.flash_attention_ref(jnp.asarray(q), kr, vr,
                                               causal=causal))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    return qt, kt, vt, causal, want


@pytest.mark.parametrize("case", EMULATED_CASES, ids=_ids)
def test_three_tf32_products_stay_within_flash_tol(case):
    q, k, v, causal, want = _emulated_and_jax(case)
    got = flash_f32_emulated(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", EMULATED_CASES, ids=_ids)
def test_one_tf32_product_misses_flash_tol(case):
    """The premise's other half: a single TF32 product a pair (hi * hi)
    lands well outside 1e-5."""
    q, k, v, causal, want = _emulated_and_jax(case)
    got = flash_f32_emulated(q, k, v, causal=causal, three=False).numpy()
    excess = np.max(np.abs(got - want) / (TOL + TOL * np.abs(want)))
    assert excess > 1, f"one TF32 product stays within 1e-5 ({excess})"


#: a long walk: hubert's encoder, full attention over 1,000 keys at D 80
#: (32 key tiles of the D-80 instance)
LONG_CASE = (1, 2, 2, 300, 1000, 80, False)


def test_tensor_core_rounding_needs_the_short_chains():
    """With each mma step rounded toward zero, as the tensor cores round,
    one accumulator over S's k-steps and O's whole walk drifts past
    1e-5 (max |error| / max |reference|, ``chip_smoke.py``'s measure);
    the kernel's short chains stay well inside."""
    q, k, v, causal, want = _emulated_and_jax(LONG_CASE)
    err = {}
    for short in (True, False):
        got = flash_f32_emulated(q, k, v, causal=causal, tc_rounding=True,
                                 short_chains=short).numpy()
        err[short] = np.abs(got - want).max() / np.abs(want).max()
    assert err[True] < TOL / 4 and err[False] > TOL, err


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, 3.0, 0.0])
    assert _tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                                 1.0, 3.0, 0.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((y - hi).abs() <= hi.abs() * 2 ** -11)
    assert torch.all((y - hi - lo).abs() <= y.abs() * 2 ** -22)
