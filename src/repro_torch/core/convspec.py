"""Structured convolution geometry (``ConvSpec``, ``ConvTransposeSpec``) and
per-pass engine selection (``EnginePolicy``).

PyTorch counterpart of ``repro.core.convspec``; both classes are plain
frozen dataclasses, so the same policy string (for example
``"fwd=pallas,dgrad=bp_phase,wgrad=pallas"``) means the same thing in both
packages.  Parsing accepts the CLI grammar with the aliases fwd/forward,
dgrad/igrad/input_grad/dx and wgrad/weight_grad/dw, plus ``"auto"`` and a
bare engine name (uniform policy).
"""

from __future__ import annotations

import dataclasses

LAYOUTS = ("NCHW", "NHWC")

#: the three lowered GEMMs of one conv layer, in dispatch order.
PASSES = ("forward", "input_grad", "weight_grad")

_PASS_ALIASES = {
    "fwd": "forward", "forward": "forward", "f": "forward",
    "dgrad": "input_grad", "igrad": "input_grad", "input_grad": "input_grad",
    "dx": "input_grad", "di": "input_grad",
    "wgrad": "weight_grad", "weight_grad": "weight_grad", "dw": "weight_grad",
}


def _pair(v, name: str) -> tuple[int, int]:
    """int | (a, b) -> (a, b) with positivity check."""
    if isinstance(v, int):
        v = (v, v)
    a, b = int(v[0]), int(v[1])
    if a < 1 or b < 1:
        raise ValueError(f"{name} must be >= 1, got {(a, b)}")
    return a, b


def _pair0(v, name: str) -> tuple[int, int]:
    """int | (a, b) -> (a, b) allowing zero (output_padding may be 0)."""
    if isinstance(v, int):
        v = (v, v)
    a, b = int(v[0]), int(v[1])
    if a < 0 or b < 0:
        raise ValueError(f"{name} must be >= 0, got {(a, b)}")
    return a, b


def _norm_padding(padding):
    """int | (ph, pw) | ((top, bottom), (left, right)) -> nested tuples."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    ph, pw = padding
    if isinstance(ph, int):
        ph = (ph, ph)
    if isinstance(pw, int):
        pw = (pw, pw)
    out = (int(ph[0]), int(ph[1])), (int(pw[0]), int(pw[1]))
    if min(out[0] + out[1]) < 0:
        raise ValueError(f"padding must be non-negative, got {out}")
    return out


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Complete static geometry of one convolution, stored normalized so
    geometrically identical specs compare and hash equal."""

    stride: tuple[int, int] = (1, 1)
    dilation: tuple[int, int] = (1, 1)
    padding: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0))
    groups: int = 1
    layout: str = "NCHW"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, "
                             f"got {self.layout!r}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")

    @classmethod
    def make(cls, stride=1, padding=0, dilation=1, groups: int = 1,
             layout: str = "NCHW") -> "ConvSpec":
        """Normalizing constructor: ints / loose pairs accepted everywhere."""
        return cls(stride=_pair(stride, "stride"),
                   dilation=_pair(dilation, "dilation"),
                   padding=_norm_padding(padding),
                   groups=int(groups), layout=layout)

    @classmethod
    def coerce(cls, value) -> "ConvSpec":
        """ConvSpec | None | dict of make() kwargs -> ConvSpec."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls.make(**value)
        raise TypeError(f"cannot interpret {value!r} as a ConvSpec")

    @property
    def s_h(self) -> int:
        return self.stride[0]

    @property
    def s_w(self) -> int:
        return self.stride[1]

    @property
    def d_h(self) -> int:
        return self.dilation[0]

    @property
    def d_w(self) -> int:
        return self.dilation[1]

    @property
    def has_dilation(self) -> bool:
        return self.dilation != (1, 1)

    def effective_kernel(self, kh: int, kw: int) -> tuple[int, int]:
        """Dilated kernel extent: K_eff = (K - 1) * D + 1 per axis."""
        return (kh - 1) * self.d_h + 1, (kw - 1) * self.d_w + 1

    def with_layout(self, layout: str) -> "ConvSpec":
        return dataclasses.replace(self, layout=layout)


@dataclasses.dataclass(frozen=True)
class ConvTransposeSpec:
    """Complete static geometry of one TRANSPOSED convolution (decoders,
    GAN generators, upsampling heads).

    ``stride`` is the input (lhs) dilation: the zero-spaced virtual input
    has ``s - 1`` zeros between pixels -- the zero space of the paper's loss
    calculation, here in a forward pass.  ``padding`` is the mirror regular
    conv's padding (it removes ``p`` border rows/cols of the full
    correlation); ``output_padding`` appends rows/cols at the bottom/right
    (``0 <= output_padding < stride`` per axis), as ``ConvTranspose2d``
    does.  ``dilation`` dilates the kernel.  Weights are
    ``(C_in, C_out/groups, K_h, K_w)``, the mirror conv's OIHW weight with
    in/out roles swapped.  The output plane is

        H_out = (H_in - 1)*s_h + K_eff_h - p_lo - p_hi + output_padding_h
    """

    stride: tuple[int, int] = (1, 1)
    dilation: tuple[int, int] = (1, 1)
    padding: tuple[tuple[int, int], tuple[int, int]] = ((0, 0), (0, 0))
    output_padding: tuple[int, int] = (0, 0)
    groups: int = 1
    layout: str = "NCHW"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, "
                             f"got {self.layout!r}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        for op, s in zip(self.output_padding, self.stride):
            if not 0 <= op < s:
                raise ValueError(
                    f"output_padding must satisfy 0 <= op < stride per "
                    f"axis, got output_padding={self.output_padding} for "
                    f"stride={self.stride}")

    @classmethod
    def make(cls, stride=1, padding=0, output_padding=0, dilation=1,
             groups: int = 1, layout: str = "NCHW") -> "ConvTransposeSpec":
        """Normalizing constructor: ints / loose pairs accepted everywhere."""
        return cls(stride=_pair(stride, "stride"),
                   dilation=_pair(dilation, "dilation"),
                   padding=_norm_padding(padding),
                   output_padding=_pair0(output_padding, "output_padding"),
                   groups=int(groups), layout=layout)

    @classmethod
    def coerce(cls, value) -> "ConvTransposeSpec":
        """ConvTransposeSpec | None | dict of make() kwargs -> spec."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls.make(**value)
        raise TypeError(f"cannot interpret {value!r} as a ConvTransposeSpec")

    s_h = ConvSpec.s_h
    s_w = ConvSpec.s_w
    d_h = ConvSpec.d_h
    d_w = ConvSpec.d_w
    has_dilation = ConvSpec.has_dilation
    effective_kernel = ConvSpec.effective_kernel

    @property
    def op_h(self) -> int:
        return self.output_padding[0]

    @property
    def op_w(self) -> int:
        return self.output_padding[1]

    def output_shape(self, h: int, w: int, kh: int, kw: int) \
            -> tuple[int, int]:
        """Spatial output plane for an (h, w) input and a COMPACT
        (kh, kw)-tap kernel."""
        keff_h, keff_w = self.effective_kernel(kh, kw)
        (ph_lo, ph_hi), (pw_lo, pw_hi) = self.padding
        return ((h - 1) * self.s_h + keff_h - ph_lo - ph_hi + self.op_h,
                (w - 1) * self.s_w + keff_w - pw_lo - pw_hi + self.op_w)

    def with_layout(self, layout: str) -> "ConvTransposeSpec":
        return dataclasses.replace(self, layout=layout)


#: sentinel engine name: the dispatcher chooses per pass.
AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """Backprop-engine selection, one slot per conv pass; each slot is an
    engine name registered in ``repro_torch.core.conv.ENGINES`` or
    ``"auto"``."""

    forward: str = AUTO
    input_grad: str = AUTO
    weight_grad: str = AUTO

    @classmethod
    def uniform(cls, engine: str) -> "EnginePolicy":
        """One engine for all three passes."""
        return cls(forward=engine, input_grad=engine, weight_grad=engine)

    @classmethod
    def parse(cls, text: str) -> "EnginePolicy":
        """Parse ``"fwd=pallas,dgrad=auto,wgrad=bp_phase"`` (unnamed passes
        default to ``auto``), ``"auto"`` or a bare engine name."""
        text = text.strip()
        if "=" not in text:
            return cls.uniform(text)
        slots = {}
        for item in text.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"bad policy item {item!r}: expected pass=engine")
            key, engine = (s.strip() for s in item.split("=", 1))
            try:
                canon = _PASS_ALIASES[key]
            except KeyError:
                raise ValueError(
                    f"unknown conv pass {key!r}; use one of "
                    f"{sorted(set(_PASS_ALIASES))}") from None
            if canon in slots:
                raise ValueError(f"duplicate policy slot for {canon!r}")
            slots[canon] = engine
        return cls(**slots)

    @classmethod
    def coerce(cls, value) -> "EnginePolicy":
        """EnginePolicy | engine-name | policy-string | dict | None."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls.parse(value)
        if isinstance(value, dict):
            return cls(**{_PASS_ALIASES[k]: v for k, v in value.items()})
        raise TypeError(f"cannot interpret {value!r} as an EnginePolicy")

    def slots(self) -> tuple[tuple[str, str], ...]:
        return tuple((p, getattr(self, p)) for p in PASSES)

    @property
    def is_uniform(self) -> bool:
        return self.forward == self.input_grad == self.weight_grad

    def __str__(self) -> str:
        if self.is_uniform:
            return self.forward
        return (f"fwd={self.forward},dgrad={self.input_grad},"
                f"wgrad={self.weight_grad}")
