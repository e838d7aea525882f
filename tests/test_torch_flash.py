"""The port's flash attention against the JAX package on the CPU: the plain
version (``repro_torch.kernels.ref.flash_attention_ref``, which the wrapper
returns for CPU tensors) against the Pallas ``flash_attention`` kernel in
interpret mode and against ``repro.kernels.ref.flash_attention_ref`` --
causal and full, ragged lengths, fewer queries than keys, grouped
key/value heads (against JAX on repeated K/V) and head dims up to 256 --
all within 1e-5 in float32.  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

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
    assert FA.LAUNCHES["flash_attention"] == 0


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
