"""Driver ``conv_layers``: a configuration's conv layers trained through
the program's conv entry, each layer's three passes a step.

A step runs, for every layer of the configuration's ``layers`` list, the
program's ``core/conv.py::conv2d`` under the configuration's engine
``policy`` and its autograd backward from a seeded upstream gradient:
the forward, the input grad and the weight grad.  The layers are not
chained (they are not consecutive in their network): each has its own
input.  The traffic's ``input_sets`` sets of inputs and upstream grads
are used in turn, step after step, so a step whose outputs are an
earlier step's reads wrong.  The window's last step's outputs are
compared, at the full batch, with the plain float32 reference.

Work a step: ``batch`` images (``conv_train_images_per_s``).

What stands in the program's place when a limit is set
(``portbench/calibrate.py``, the tests): :func:`control`, the reference
at a lower precision, and :data:`FAULTS`, the program with a fault
planted.  A program is made by a factory from the configuration."""

from __future__ import annotations

import torch

from portbench.lib import compare, convwork, seeds
from portbench.reference import conv as ref_conv

RATE_METRIC = "conv_train_images_per_s"


class ProgramConv:
    """The system under test: ``repro_torch.core.conv.conv2d`` and the
    autograd backward of its output."""

    def __init__(self, policy: str):
        from repro_torch.core import conv as C
        from repro_torch.core.convspec import ConvSpec
        self.conv, self.spec_cls, self.policy = C, ConvSpec, policy

    def spec(self, layer: dict):
        return self.spec_cls.make(stride=layer["S"], padding=layer["P"])

    def run(self, x, w, dy, spec):
        y = self.conv.conv2d(x, w, spec, self.policy)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        return y.detach(), dx, dw

    def reset_counts(self) -> None:
        self.conv.reset_dispatch_events()

    def off_policy(self) -> int:
        """Passes since the last reset that ran on another engine than
        the policy names (``dispatch_events``)."""
        return sum(n for k, n in self.conv.dispatch_events().items()
                   if k.split(":")[1:] != [self.policy])


def program(config: dict) -> ProgramConv:
    return ProgramConv(config["policy"])


class ReferenceConv:
    """The reference in the program's place, its operands rounded to
    ``precision``."""

    def __init__(self, precision: str):
        self.precision = precision

    def spec(self, layer: dict):
        return (layer["S"], layer["P"])

    def run(self, x, w, dy, spec):
        return ref_conv.passes(x.detach(), w.detach(), dy, *spec,
                               precision=self.precision)

    def reset_counts(self) -> None:
        pass

    def off_policy(self) -> int:
        return 0


def control(precision: str):
    return lambda config: ReferenceConv(precision)


class _Fault:
    """The program with a fault planted around its passes."""

    def __init__(self, config: dict):
        self.inner = program(config)

    def spec(self, layer):
        return self.inner.spec(layer)

    def reset_counts(self):
        self.inner.reset_counts()

    def off_policy(self):
        return self.inner.off_policy()


class Stale(_Fault):
    """A step returns the outputs of the layer's previous step."""

    def __init__(self, config):
        super().__init__(config)
        self.prev = {}

    def run(self, x, w, dy, spec):
        out = self.inner.run(x, w, dy, spec)
        old = self.prev.get(id(spec), out)
        self.prev[id(spec)] = out
        return old


class HalfBatch(_Fault):
    """Half the images left out: their outputs and input grads zero, the
    weight grad the first half's, doubled."""

    def run(self, x, w, dy, spec):
        h = x.shape[0] // 2
        xh = x.detach()[:h].clone().requires_grad_(True)
        y, dx, dw = self.inner.run(xh, w, dy[:h].contiguous(), spec)

        def pad(t):
            return torch.cat([t, t.new_zeros((x.shape[0] - h, *t.shape[1:]))])
        return pad(y), pad(dx), dw * 2


class Altered(_Fault):
    """One output value changed by 1 where the forward produces it."""

    def run(self, x, w, dy, spec):
        y, dx, dw = self.inner.run(x, w, dy, spec)
        y = y.clone(memory_format=torch.contiguous_format)
        y.view(-1)[0] += 1.0
        return y, dx, dw


FAULTS = {"stale": Stale, "half_batch": HalfBatch, "altered": Altered}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program=program):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.batch = int(traffic["batch"])
        self.layers = config["layers"]
        self.units_per_step = self.batch
        self.program = program(config)
        self.steps = 0
        self.last = None

    # -- geometry and work ----------------------------------------------
    def geometries(self) -> list[convwork.ConvGeometry]:
        return [convwork.square(self.batch, la) for la in self.layers]

    def conv_layers(self) -> dict[tuple, tuple]:
        """``{span key: (geometry, dtype name)}`` of every conv a step
        runs."""
        return {g.span_key(): (g, self.config["dtype"])
                for g in self.geometries()}

    def flops_per_step(self) -> int:
        return sum(3 * convwork.pass_flops(g) for g in self.geometries())

    # -- set-up, steps ---------------------------------------------------
    def setup(self) -> None:
        dev, dt = self.device, self.dtype
        self.w, self.x, self.dy, self.specs = [], [], [], []
        for i, (layer, g) in enumerate(zip(self.layers, self.geometries())):
            gen = seeds.generator(dev, self.seed, "conv", i, "w")
            fan_in = g.C * g.K_h * g.K_w
            w = seeds.normal(gen, (g.N, g.C, g.K_h, g.K_w), fan_in ** -0.5,
                             dt, dev)
            self.w.append(w.requires_grad_(True))
            self.specs.append(self.program.spec(layer))
        for s in range(int(self.traffic["input_sets"])):
            xs, dys = [], []
            for i, g in enumerate(self.geometries()):
                gen = seeds.generator(dev, self.seed, "conv", i, "set", s)
                xs.append(seeds.normal(gen, (g.B, g.C, g.H, g.W), 1.0, dt, dev)
                          .requires_grad_(True))
                dys.append(seeds.normal(gen, (g.B, g.N, g.H_o, g.W_o), 1.0,
                                        dt, dev))
            self.x.append(xs)
            self.dy.append(dys)
        self.program.reset_counts()
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()

    def step(self) -> None:
        s = self.steps % len(self.x)
        self.last = None
        outs = [self.program.run(self.x[s][i], self.w[i], self.dy[s][i],
                                 self.specs[i])
                for i in range(len(self.layers))]
        self.last = (s, outs)
        self.steps += 1

    def failed_steps(self) -> int:
        return 0

    def release(self) -> None:
        """Read the program's dispatch counts and free what only it holds;
        the inputs and the last step's outputs stay for :meth:`check`."""
        self.off_policy = self.program.off_policy()
        self.program = None

    # -- the comparison ----------------------------------------------------
    def check(self) -> list[tuple]:
        """Every layer's output, input grad and weight grad of the last
        step against the reference's; the worst layer of each pass."""
        s, outs = self.last
        worst = [0.0, 0.0, 0.0]
        for i, layer in enumerate(self.layers):
            want = ref_conv.passes(self.x[s][i].detach(), self.w[i].detach(),
                                   self.dy[s][i], layer["S"], layer["P"])
            for j, (got, ref) in enumerate(zip(outs[i], want)):
                worst[j] = max(worst[j], compare.rel_err(got, ref))
            del want
        lim = self.config["limits"]
        return [("fwd_err", worst[0], lim["fwd_err"]),
                ("dgrad_err", worst[1], lim["dgrad_err"]),
                ("wgrad_err", worst[2], lim["wgrad_err"]),
                ("off_policy_passes", float(self.off_policy),
                 lim["off_policy_passes"])]
