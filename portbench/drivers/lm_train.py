"""Driver ``lm_train``: a language model trained through the program's
train step.

Set-up makes the weights from the seed on the device
(``lib/mamba2_params.py``), hands them to one train step object -- the
program's ``train/train_step.py::make_train_step`` step with its model
and AdamW state, the numerical guard on -- and drives it through the
first ``checked_steps`` steps, the same call and feed as the window's.
Then the same object trains on in the window, a batch a step: rows of
seeded random tokens, a new batch each step, dispatched without reading
anything back.

What the check compares comes from those first steps: each step's loss,
the first gradient's global norm as AdamW got it, before its clip (the
``grad_norm`` AdamW reports), each leaf's first gradient as AdamW
applied it (its first moment after one step over ``1 - b1``) and each
leaf's change after them, all against the plain float32 reference
(``reference/mamba2.py``) run from the same weights and batches once the
window has closed.

Work a step: ``batch * seq`` tokens (``lm_train_tokens_per_s``).

What stands in the program's place when a limit is set
(``portbench/calibrate.py``, the tests): :func:`control`, the reference
trained at a lower precision, and :data:`FAULTS`, the program with a
fault planted.  A program is made by a factory from the configuration,
the weights and the device."""

from __future__ import annotations

import dataclasses
import statistics

import torch

from portbench.lib import compare, convwork, lmwork, seeds
from portbench.lib import mamba2_params as MP
from portbench.reference import mamba2 as ref

RATE_METRIC = "lm_train_tokens_per_s"


def batch(seed: int, step: int, rows: int, seq: int, vocab: int, device):
    """Step ``step``'s ``(tokens, targets)``: seeded random ids, the
    targets the tokens shifted by one."""
    g = seeds.generator(device, seed, "lm-batch", step)
    ids = torch.randint(0, vocab, (rows, seq + 1), generator=g,
                        device=device)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def arch_config(config: dict):
    """The program's ``ArchConfig`` with the configuration file's sizes;
    raises on a setting the program's Mamba2 does not have."""
    from repro_torch.configs import get_config
    fixed = {"ngroups": 1, "d_intermediate": 0, "rms_norm": True,
             "conv_bias": False, "residual_dtype": config["act_dtype"],
             "gated_norm_eps": 1e-6}
    for key, want in fixed.items():
        if config[key] != want:
            raise ValueError(f"{key}={config[key]!r}: the program's Mamba2 "
                             f"runs {key}={want!r} only")
    s = lmwork.mamba2_sizes(config)
    return dataclasses.replace(
        get_config(config["arch"]), n_layers=s["layers"],
        d_model=s["d_model"], vocab=s["vocab_rows"],
        n_heads=s["heads"], n_kv_heads=s["heads"],
        head_dim=config["headdim"], ssm_state=s["d_state"],
        ssm_conv=s["width"], ssm_expand=config["expand"],
        ssm_head_dim=config["headdim"],
        tie_embeddings=config["tie_embeddings"],
        param_dtype=config["param_dtype"], act_dtype=config["act_dtype"],
        norm_eps=config["norm_eps"])


class ProgramTrainer:
    """The system under test: one train step object and its state."""

    def __init__(self, config: dict, params: dict, device):
        from repro_torch.core import conv as C
        from repro_torch.models import model as M
        from repro_torch.optim import adamw
        from repro_torch.train import train_step as TS
        cfg = arch_config(config)
        meta = MP.flatten(M.init_params(torch.Generator(), cfg, "meta"))
        mine = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
        theirs = {k: (tuple(v.shape), v.dtype) for k, v in meta.items()}
        if mine != theirs:
            raise ValueError(f"the program's Mamba2 tree differs from the "
                             f"benchmark's: {theirs} against {mine}")
        opt = config["optimizer"]
        self.b1 = opt["b1"]
        self.conv, self.policy = C, config["policy"]
        self.step_fn = TS.make_train_step(
            cfg, adamw.AdamWConfig(
                peak_lr=opt["peak_lr"], b1=opt["b1"], b2=opt["b2"],
                eps=opt["eps"], weight_decay=opt["weight_decay"],
                clip_norm=opt["clip_norm"]),
            total_steps=opt["total_steps"], warmup=opt["warmup"],
            conv_policy=config["policy"], guard=True)
        self.params = MP.nest(params)
        self.opt = adamw.init_state(self.params)
        self.n = 0
        self.bad = torch.zeros((), dtype=torch.float32, device=device)
        C.reset_dispatch_events()

    def step(self, tokens, targets):
        self.params, self.opt, m = self.step_fn(
            self.params, self.opt, {"tokens": tokens, "targets": targets},
            self.n)
        if self.n == 0:
            self.raw_norm = m["grad_norm"]
        self.n += 1
        self.bad += m["guard_bad"]
        return m["loss"]

    def first_raw_grad_norm(self) -> float:
        """The first step's global gradient norm before the clip, as
        AdamW reported it."""
        return float(self.raw_norm)

    def first_grad_norms(self) -> dict[str, float]:
        """After one step: each leaf's gradient norm as AdamW took it."""
        return {k: float(torch.linalg.vector_norm(v)) / (1 - self.b1)
                for k, v in MP.flatten(self.opt["m"]).items()}

    def params_flat(self) -> dict:
        return MP.flatten(self.params)

    def failed_steps(self) -> int:
        return int(self.bad)

    def off_policy(self) -> int:
        return sum(n for k, n in self.conv.dispatch_events().items()
                   if k.split(":")[1:] != [self.policy])


def program(config: dict, params: dict, device) -> ProgramTrainer:
    return ProgramTrainer(config, params, device)


class ReferenceTrainer:
    """The reference's AdamW training in the program's place, its matrix
    products' operands rounded to ``precision``."""

    def __init__(self, precision: str, config: dict, params: dict):
        self.trainer = ref.Trainer(params, lmwork.mamba2_sizes(config),
                                   config["norm_eps"], config["optimizer"],
                                   precision)

    def step(self, tokens, targets):
        return torch.tensor(self.trainer.step(tokens, targets))

    def first_grad_norms(self) -> dict[str, float]:
        return dict(self.trainer.first)

    def first_raw_grad_norm(self) -> float:
        return self.trainer.first_raw

    def params_flat(self) -> dict:
        return self.trainer.stored

    def failed_steps(self) -> int:
        return 0

    def off_policy(self) -> int:
        return 0


def control(precision: str):
    return lambda config, params, device: ReferenceTrainer(
        precision, config, params)


def _fault(kind: str):
    """A factory of the program with fault ``kind`` planted in its step:
    ``unchanged`` (the step returns the state it was given), ``half_batch``
    (the loss and grads of the first half of the rows, the mean over
    them), ``altered`` (one value of the updated parameters, the final
    norm's first scale, changed by 1 where the update produces it)."""
    def make(config, params, device):
        prog = program(config, params, device)
        inner = prog.step

        def step(tokens, targets):
            if kind == "half_batch":
                h = tokens.shape[0] // 2
                return inner(tokens[:h], targets[:h])
            before = (prog.params, prog.opt)
            loss = inner(tokens, targets)
            if kind == "unchanged":
                prog.params, prog.opt = before
            else:
                with torch.no_grad():
                    prog.params["final_norm"]["scale"].view(-1)[0] += 1.0
            return loss
        prog.step = step
        return prog
    return make


FAULTS = {kind: _fault(kind) for kind in ("unchanged", "half_batch",
                                          "altered")}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program=program):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.sizes = lmwork.mamba2_sizes(config)
        self.rows, self.seq = int(traffic["batch"]), int(traffic["seq"])
        self.units_per_step = self.rows * self.seq
        self.make_program = program
        self.steps = 0

    def batch(self, step: int):
        return batch(self.seed, step, self.rows, self.seq,
                     self.config["vocab_size"], self.device)

    def conv_layers(self) -> dict[tuple, tuple]:
        g = convwork.causal_depthwise(self.rows, self.seq,
                                      self.sizes["conv_channels"],
                                      self.sizes["width"])
        return {g.span_key(): (g, self.config["act_dtype"])}

    def flops_per_step(self) -> float:
        return lmwork.model_flops(lmwork.mamba2_param_count(self.config),
                                  self.units_per_step)

    def setup(self) -> None:
        params = MP.make(self.config, self.seed, self.device)
        start = {k: v.clone() for k, v in params.items()}
        self.program = self.make_program(self.config, params, self.device)
        del params
        losses = []
        for i in range(int(self.traffic["checked_steps"])):
            losses.append(self.program.step(*self.batch(i)))
            if i == 0:
                self.grad_norms = self.program.first_grad_norms()
                self.raw_grad_norm = self.program.first_raw_grad_norm()
            self.steps += 1
        self.losses = [float(v) for v in losses]
        now = self.program.params_flat()
        self.change_norms = {
            k: float(torch.linalg.vector_norm(now[k].float()
                                              - start[k].float()))
            for k in start}

    def step(self) -> None:
        self.program.step(*self.batch(self.steps))
        self.steps += 1

    def failed_steps(self) -> int:
        return self.program.failed_steps()

    def release(self) -> None:
        self.off_policy = self.program.off_policy()
        self.program = None

    def check(self) -> list[tuple]:
        n = int(self.traffic["checked_steps"])
        params = MP.make(self.config, self.seed, self.device)
        want = ref.train(params, [self.batch(i) for i in range(n)],
                         self.sizes, self.config["norm_eps"],
                         self.config["optimizer"])
        loss_gaps = [abs(a - b) / abs(b)
                     for a, b in zip(self.losses, want["losses"])]
        grad = compare.leaf_gaps(self.grad_norms, want["grad_norms"])
        change = compare.leaf_gaps(self.change_norms, want["change_norms"],
                                   compare.moved_leaves(want["grad_norms"]))
        numbers = {"loss_gap": max(loss_gaps),
                   "first_loss_gap": loss_gaps[0],
                   "raw_grad_norm_gap": abs(self.raw_grad_norm
                                            - want["raw_grad_norm"])
                   / want["raw_grad_norm"],
                   "grad_norm_gap": max(grad.values()),
                   "grad_norm_gap_median": statistics.median(grad.values()),
                   "change_norm_gap": max(change.values()),
                   "change_norm_gap_median":
                       statistics.median(change.values()),
                   "off_policy_passes": float(self.off_policy)}
        self.details = {"numbers": numbers, "loss_gaps": loss_gaps,
                        "grad_norm_gaps": grad, "change_norm_gaps": change,
                        "ref_grad_norms": want["grad_norms"],
                        "ref_change_norms": want["change_norms"]}
        # Compared: the numbers the configuration gives a limit; the
        # others are kept in ``details`` for the calibration.
        return [(k, v, self.config["limits"][k]) for k, v in numbers.items()
                if k in self.config["limits"]]
