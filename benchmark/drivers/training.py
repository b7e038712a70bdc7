"""PC2 training steps as `train_loop` issues them: `make_train_step` over
`PC2Model.loss` with `make_optimizer` on the model with its image
features frozen, a fresh seeded batch every step, the host never waiting.

Set-up builds the one training state, drives it through its first three
steps (the warm-up), keeps what the comparison needs, and hands the same
state to the window. Each of the first three steps' loss, the first
gradient as the optimizer got it (its AdamW state after one step:
exp_avg / (1 - beta1)), and every parameter's change after the three are
held to the reference, which follows the same three steps from the same
weights, batches, timesteps, noise and dropout masks:

  loss     |L_prog - L_ref| / |L_ref| of the first step;
  grad     the median over the leaves of | ||g_prog|| - ||g_ref|| | over
           the larger of ||g_ref|| and the median leaf's ||g_ref||, in
           units of the same median for the reference at bfloat16
           operands on the same seed and draws (seeds differ in how far
           rounding moves the gradient by 5x, both precisions alike);
  change   the same of the parameters' change after three steps, over the
           leaves whose reference gradient is at least a thousandth of
           the median leaf's (below that, Adam moves a leaf by rounding);
  exact    window steps whose loss is not finite.

The median leaf and not the worst: the worst leaf's gap swings from seed
to seed, in the reference rounded to bfloat16 as in the program, as far
as the fp8 control's (the readings are in `PERF.md`). The first step's
loss and not every step's: from the second step on, the two sides start
from parameters that already differ by Adam's normalised update of
slightly different gradients. The worst leaf's gaps and every step's
loss gap are logged.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Dict, List

import torch

from benchmark import counting, traffic
from benchmark.drivers import common
from benchmark import harness
from benchmark.harness import Check, Outcome
from benchmark.reference.diffusion import DDPM
from benchmark.reference.models import PC2
from benchmark.reference.precision import Precision, no_tf32
from benchmark.reference.pvcnn import Run
from benchmark.reference.training import (AdamW, decay_names, leaf_norms,
                                          pc2_loss, trainable)
from benchmark.trace import Stretch, combine, own_kernels

CHECKED = 3         # the steps the reference follows
TRACE_STEPS = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Noise:
    """What the loss draws each step (timesteps, noise, dropout
    keep-masks), from the run's seed on the device; the draws of the first
    `CHECKED` steps are kept."""

    def __init__(self, seed: int, dev):
        self.gen = traffic.generator(seed, 21, dev)
        self.drop = traffic.generator(seed, 22, dev)
        self.dev = dev
        self.kept: List[dict] = []
        self.record = True

    def next_step(self) -> None:
        self.record = len(self.kept) < CHECKED
        if self.record:
            self.kept.append({"masks": []})

    def draw(self, shape, num_timesteps: int):
        t = torch.randint(0, int(num_timesteps), (shape[0],),
                          generator=self.gen, device=self.dev)
        eps = torch.randn(shape, generator=self.gen, device=self.dev)
        if self.record:
            self.kept[-1].update(t=t, eps=eps)
        return t, eps

    def keep_mask(self, shape, p: float):
        keep = torch.rand(tuple(shape), generator=self.drop,
                          device=self.dev) < 1.0 - p
        if self.record:
            self.kept[-1]["masks"].append(keep)
        return keep


def first_gradient(opt, named, beta1: float) -> Dict[str, torch.Tensor]:
    """The gradient AdamW took in its first step, from its state:
    exp_avg / (1 - beta1); zeros for a parameter it holds no state of."""
    out = {}
    for name, p in named:
        m = opt.optimizer.state.get(p, {}).get("exp_avg")
        out[name] = (torch.zeros_like(p) if m is None
                     else m / (1.0 - beta1))
    return out


def run(cell, seed: int, seconds: float, trace: bool, control: bool, dev,
        t0: float) -> Outcome:
    from bdm_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step, pc2_freeze_mask)
    cfg, mix = cell.config, cell.traffic
    opt_cfg = cfg["optimizer"]
    build_s = common.build_kernels(dev)
    sd = common.seeded_state("pc2", cfg, seed, dev)
    model = common.pc2_program(cfg, dev)
    model.load_state_dict(sd)
    pc2_freeze_mask(model)
    opt = make_optimizer(model, "AdamW", lr=opt_cfg["lr"],
                         weight_decay=opt_cfg["weight_decay"],
                         betas=tuple(opt_cfg["betas"]),
                         clip_grad_norm=opt_cfg["clip_grad_norm"])
    state = create_train_state(model, opt, use_ema=cfg["use_ema"])
    step = make_train_step(model.loss)
    noise = Noise(seed, dev)
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]

    def batch(k):
        b = traffic.train_batch(mix, seed, k, dev)
        return dict(b, camera=common.camera(b["camera"]))

    losses = []
    k = 0
    for k in range(CHECKED):
        noise.next_step()
        losses.append(step(state, batch(k),
                           noise)["loss"])
        if k == 0:
            g1 = first_gradient(opt, named, opt_cfg["betas"][0])
    after = {name: p.detach().clone() for name, p in named}
    prog_losses = torch.stack(losses)
    common.sync(dev)
    setup_s = time.perf_counter() - t0
    log(f"{cell.name}: set-up {setup_s:.3f} s (kernel build or load "
        f"{build_s:.3f} s)")

    window: List[torch.Tensor] = []
    with harness.quiet_host():
        t_start = time.perf_counter()
        while True:
            k += 1
            noise.next_step()
            window.append(step(state, batch(k), noise)["loss"])
            if time.perf_counter() - t_start >= seconds:
                break
        common.sync(dev)
        window_s = time.perf_counter() - t_start
    memory = common.peak_bytes(dev)
    steps = len(window)

    c = cfg["pc2"]
    b, n = mix["batch"], mix["points"]
    net = counting.pvcnn2(c["sa_blocks"], c["fp_blocks"],
                          3 + c["vit"]["embed_dim"], c["embed_dim"], n)
    v = c["vit"]
    per_step = 3 * counting.pvcnn2_flops(net, b) + counting.vit_flops(
        b, c["image_size"], v["patch_size"], v["embed_dim"], v["depth"])
    bf16 = cfg["precision"] == "bf16"
    outcome = Outcome(
        kind="train", setup_s=setup_s, window_s=window_s, steps=steps,
        flops=per_step * steps,
        end_to_end={"train_step_ms": window_s / steps * 1e3,
                    "setup_s": setup_s},
        checks=[], attempted=0, memory_peak_bytes=memory,
        bound_s_per_step=counting.bound_s(
            counting.kernel_launches(net, b, bf16, backward=True)),
        peak_flops=counting.PEAK_FLOPS["bf16" if bf16 else "f32"])
    log(f"{cell.name}: window {window_s:.3f} s, {steps} steps, "
        f"{outcome.end_to_end['train_step_ms']:.4f} ms a step; peak memory "
        f"{memory} bytes")

    if trace:
        own = own_kernels(cell.root)
        sums = []
        for stretch in (Stretch(), Stretch(host_ops=True)):
            stretch.start()
            for _ in range(TRACE_STEPS):
                k += 1
                noise.next_step()
                window.append(step(state, batch(k), noise)["loss"])
            stretch.stop()
            sums.append(stretch.summary(TRACE_STEPS, own))
        outcome.trace = combine(*sums)
        log(f"{cell.name}: traced {TRACE_STEPS} steps in "
            f"{sums[0].wall_s:.4f} s, {sums[1].wall_s:.4f} s with the host's "
            f"operations; {sums[0].launches} launches; own kernels "
            f"{outcome.trace.own_by_kernel}")

    bad = int((~torch.isfinite(torch.stack(window))).sum())
    prog = {"losses": [float(x) for x in prog_losses.cpu()], "g1": g1,
            "after": after}
    del state, opt, model, step, named
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    outcome.checks, outcome.notes["control"] = compare(
        cfg, mix, seed, sd, noise.kept, prog, dev, control)
    outcome.checks.append(Check("exact", float(bad), 0.0))
    outcome.attempted = CHECKED + steps
    log(f"{cell.name}: comparison {time.perf_counter() - t:.3f} s")
    return outcome


def _half(batch, d):
    """The first half of a step's rows, with their draws."""
    h = batch["points"].shape[0] // 2
    cam = {k: v[:h] for k, v in batch["camera"].items()}
    return (dict(batch, image=batch["image"][:h], points=batch["points"][:h],
                 camera=cam),
            dict(d, t=d["t"][:h], eps=d["eps"][:h],
                 masks=[m[:h] for m in d["masks"]]))


def reference_steps(cfg, mix, seed, sd, kept, dev, precision: Precision,
                    fault: str = ""):
    """The reference's three steps -> (losses, first clipped gradients,
    changes after three), by parameter name. `fault` plants one of the
    faults the comparison must catch into the reference put in the
    program's place: "half_batch" (the loss of half the rows stands for
    the batch's), "loss" (the loss doubled where it is produced)."""
    c, o = cfg["pc2"], cfg["optimizer"]
    ref = PC2(c).to(dev)
    ref.load_state_dict(sd)
    ref.train()
    names = trainable(ref)
    params = dict(ref.named_parameters())
    for k, p in params.items():
        p.requires_grad_(k in names)
    opt = AdamW({k: params[k] for k in names}, decay_names(ref), o["lr"],
                o["betas"], o["weight_decay"], 1e-8, o["clip_grad_norm"])
    ddpm = DDPM(c["beta_start"], c["beta_end"])
    losses, g1 = [], None
    for k in range(CHECKED):
        batch = traffic.train_batch(mix, seed, k, dev)
        d = kept[k]
        if d.get("eps") is None or d["eps"].shape != batch["points"].shape:
            raise ValueError(f"step {k} drew no noise of the batch's shape")
        if fault == "half_batch":
            batch, d = _half(batch, d)
        loss = pc2_loss(ref, ddpm, batch, d["t"], d["eps"], d["masks"],
                        Run(precision)) * (2.0 if fault == "loss" else 1.0)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        used = opt.step(dict(zip(names, grads)))
        losses.append(float(loss.detach()))
        if k == 0:
            g1 = used
    change = {n: (params[n].detach() - sd[n]) for n in names}
    return losses, g1, change


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          leaves) -> Dict[str, float]:
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def _worst(gaps: Dict[str, float], prog, ref, n: int = 5) -> list:
    return [(k, round(g, 4), prog[k], ref[k]) for k, g in
            sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def readings(prog, ref) -> Dict[str, float]:
    losses, g1, change = ref
    gp, gr = leaf_norms(prog["g1"]), leaf_norms(g1)
    cp, cr = leaf_norms({k: prog["after"][k] - prog["sd"][k]
                         for k in change}), leaf_norms(change)
    med = statistics.median(gr.values())
    moved = [k for k in gr if gr[k] >= 1e-3 * med]
    g_gaps, c_gaps = _gaps(gp, gr, gr), _gaps(cp, cr, moved)
    log(f"worst leaves, first gradient (leaf, gap, program, reference): "
        f"{_worst(g_gaps, gp, gr)}; median {med}")
    log(f"worst leaves, change after {CHECKED} steps: "
        f"{_worst(c_gaps, cp, cr)}; median {statistics.median(cr.values())}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses)]
    log(f"worst leaf: grad {max(g_gaps.values())}, change "
        f"{max(c_gaps.values())}; the three steps' loss gaps {gaps}")
    return {
        "loss": gaps[0],
        "grad": statistics.median(g_gaps.values()),
        "change": statistics.median(c_gaps.values())}


def _as_program(ref_steps, sd) -> dict:
    losses, g1, change = ref_steps
    return {"losses": losses, "g1": g1, "sd": sd,
            "after": {k: sd[k] + v for k, v in change.items()}}


def compare(cfg, mix, seed, sd, kept, prog, dev, control: bool):
    """-> (checks, the control's and the planted faults' checks when
    `control`). `grad` is the median leaf's gap over the same gap of the
    reference at bfloat16 operands on the same seed and draws: how far
    the program's first gradient lies from float32, in units of the
    configured precision's own rounding on this seed."""
    def step(kind="float32", fault=""):
        return reference_steps(cfg, mix, seed, sd, kept, dev,
                               Precision(kind), fault)

    with no_tf32():
        try:
            ref = step()
        except ValueError as e:
            # the program drew what the batch does not need: no reading
            log(f"the reference cannot follow the program's draws: {e}")
            return [Check(k, math.inf, cfg["limits"][k])
                    for k in ("loss", "grad", "change")], {}
        unit = readings(_as_program(step("bfloat16"), sd), ref)["grad"]

        def scaled(r):
            return dict(r, grad=r["grad"] / max(unit, 1e-9))

        log(f"the reference at bfloat16 operands: median leaf's gradient "
            f"gap {unit}")
        got = scaled(readings(dict(prog, sd=sd), ref))
        ctrl = {}
        if control:
            for kind, fault in (("fp8", ""), ("float32", "half_batch"),
                                ("float32", "loss")):
                name = fault or kind
                r = scaled(readings(_as_program(step(kind, fault), sd), ref))
                log(f"control or fault readings ({name}): {r}")
                ctrl[name] = checks(r, cfg["limits"])
    log(f"program readings: {got}")
    return checks(got, cfg["limits"]), ctrl


def checks(got: Dict[str, float], limits: dict) -> List[Check]:
    """The cell's checks of one set of readings (the program's, or a
    control's or a fault's in its place)."""
    return [Check(k, v, limits[k]) for k, v in got.items()]
