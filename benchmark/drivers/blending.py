"""BDM-Blending sampling over slices of the production trajectory.

The window calls the port's `bdm_blending` once a slice, over the fixed
list of slices the traffic names (`window`, positions in `slices`; all of
them in order by default), so that every run does the same work whatever
the program's speed: `--seconds` does not change it. A slice starts from
the cloud its production predecessor returned when that slice ran just
before it in the list (the benchmark's noise object hands it over as the
initial cloud, and the sampler centres it as it centres fresh noise),
and from fresh noise otherwise. A step is one network forward with its
scheduler update; the window waits for the device at the end of each
slice, which gives each slice's wall.

What the timed path produced is held to the reference step by step, from
the program's own state: in every slice of the window the harness's
hooks keep, for one step of each chain of forwards (each segment, roll
and prior window between two milestones) drawn from the seed, the cloud
that went into the forward and the cloud that went into the next forward
of the chain, and the noise the step drew, and the same around every
blend. The reference takes the same input cloud, computes the step at
float32 and is compared with what came out:

  pc2_step, pvd_step   ||x_prog - x_ref|| / ||c eps_ref|| (c eps_ref: the
                       part of the step the network decides), the largest
                       over the run's compared steps;
  blend                the same over the blends and the two roll steps
                       before each;
  exact                mismatches of what is fixed: each slice's forwards
                       and blends against the plan, the sampled steps'
                       timesteps, each slice's first input against its
                       centred initial cloud, finite outputs.

So a fault confined to one milestone's window of one slice still meets a
compared step. The first input of each slice is what the stepwise
comparison skips, and `exact` checks it by itself; the conditioning map
is recomputed by the reference at every compared step. Every compared
step's reading is logged.
"""

from __future__ import annotations

import math
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import counting, traffic
from benchmark.drivers import common
from benchmark import harness
from benchmark.harness import Check, Outcome
from benchmark.reference.diffusion import DDPM, Gaussian, blend
from benchmark.reference.models import PC2, PVD
from benchmark.reference.precision import Precision, no_tf32
from benchmark.reference.pvcnn import Run
from benchmark.trace import Stretch, combine, own_kernels

WARMUP = ([1000, 999, 998, 997], 1)     # milestones, roll: every shape
TRACE_FROM, TRACE_STEPS = 20, 12        # PC2 forwards of the traced slice


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Noise:
    """The run's noise: fresh initial clouds (or the carried one), step
    noise and blend coins from one generator on the device. A slice's
    draws named in `keep` are kept for the comparison."""

    def __init__(self, seed: int, dev):
        self.gen = traffic.generator(seed, 7, dev)
        self.dev = dev
        self.carry: Optional[torch.Tensor] = None
        self.keep: set = set()
        self.kept: Dict[tuple, torch.Tensor] = {}
        self.masks = 0
        self.first: Optional[torch.Tensor] = None

    def initial(self, shape):
        x = (torch.randn(shape, generator=self.gen, device=self.dev)
             if self.carry is None else self.carry)
        self.first = x
        return x

    def step(self, branch, i, j, n, shape):
        z = torch.randn(shape, generator=self.gen, device=self.dev)
        if (branch, i, j) in self.keep:
            self.kept[(branch, i, j)] = z
        return z

    def mask(self, i, shape):
        self.masks += 1
        m = torch.randint(0, 2, shape, generator=self.gen, device=self.dev)
        if ("mask", i) in self.keep:
            self.kept[("mask", i)] = m
        return m


@dataclass
class SliceRecord:
    plan: traffic.Plan
    pc2_pairs: List[int]
    pvd_pairs: List[int]
    blends: List[Tuple[int, int, int, Optional[int]]]
    want_pc2: set
    want_pvd: set
    pc2: Dict[int, tuple] = field(default_factory=dict)
    pvd: Dict[int, tuple] = field(default_factory=dict)
    kept: Dict[tuple, torch.Tensor] = field(default_factory=dict)
    counts: Tuple[int, int, int] = (0, 0, 0)
    initial: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None


def _chains(fw: List[traffic.Forward]) -> List[List[int]]:
    """The steps k whose next forward k + 1 continues the same chain
    (branch and milestone), grouped by chain."""
    out: Dict[tuple, List[int]] = {}
    for k in range(len(fw) - 1):
        if (fw[k].branch, fw[k].i) == (fw[k + 1].branch, fw[k + 1].i):
            out.setdefault((fw[k].branch, fw[k].i), []).append(k)
    return list(out.values())


def choose(p: traffic.Plan, rng: random.Random) -> SliceRecord:
    """The steps of one slice to compare, drawn from the run's seed: one
    step of every chain of PC2 and of PVD forwards, and every blend, each
    with the input of the forward after it."""
    pc2, pvd = p.of("pc2"), p.of("pvd")
    a = [rng.choice(c) for c in _chains(pc2)]
    v = [rng.choice(c) for c in _chains(pvd)]
    want_pc2 = {0} | set(a) | {k + 1 for k in a}
    want_pvd = set(v) | {k + 1 for k in v}
    blends = []
    for i in p.blends:
        r = max(k for k, f in enumerate(pc2)
                if f.branch == "recon" and f.i == i)
        q = max(k for k, f in enumerate(pvd) if f.i == i)
        nxt = r + 1 if r + 1 < len(pc2) else None
        blends.append((i, r, q, nxt))
        want_pc2 |= {r} | ({nxt} if nxt is not None else set())
        want_pvd |= {q}
    return SliceRecord(p, a, v, blends, want_pc2, want_pvd)


class Hooks:
    """Forward pre-hooks on the two networks: count the forwards of the
    current slice, keep the inputs the record asks for, and start or stop
    a traced stretch at given PC2 forwards (`stretches`: forward ->
    ("start" or "stop", stretch))."""

    def __init__(self, pc2_net, pvd_net):
        self.rec: Optional[SliceRecord] = None
        self.n_pc2 = self.n_pvd = 0
        self.stretches: Dict[int, Tuple[str, Stretch]] = {}
        self.handles = [pc2_net.register_forward_pre_hook(self._pc2),
                        pvd_net.register_forward_pre_hook(self._pvd)]

    def begin(self, rec: Optional[SliceRecord]) -> None:
        self.rec = rec
        self.n_pc2 = self.n_pvd = 0

    def _pc2(self, mod, args):
        k = self.n_pc2
        self.n_pc2 += 1
        if k in self.stretches:
            what, stretch = self.stretches[k]
            getattr(stretch, what)()
        if self.rec is not None and k in self.rec.want_pc2:
            self.rec.pc2[k] = (args[0][..., :3].clone(), args[1].clone())

    def _pvd(self, mod, args):
        k = self.n_pvd
        self.n_pvd += 1
        if self.rec is not None and k in self.rec.want_pvd:
            self.rec.pvd[k] = (args[0].clone(), args[1].clone())

    def close(self) -> None:
        for h in self.handles:
            h.remove()


def _key(f: traffic.Forward) -> tuple:
    return (f.branch, f.i, f.j)


def run(cell, seed: int, seconds: float, trace: bool, control: bool, dev,
        t0: float) -> Outcome:
    from bdm_tpu_torch.samplers import bdm_blending
    cfg, mix = cell.config, cell.traffic
    build_s = common.build_kernels(dev)
    sd_pc2 = common.seeded_state("pc2", cfg, seed, dev)
    sd_pvd = common.seeded_state("pvd", cfg, seed, dev)
    pc2 = common.pc2_program(cfg, dev)
    pvd = common.pvd_program(cfg, dev)
    pc2.load_state_dict(sd_pc2)
    pvd.load_state_dict(sd_pvd)
    inputs = traffic.sample_inputs(mix, seed, dev)
    batch = {"image": inputs["image"],
             "camera": common.camera(inputs["camera"])}
    n, s_inf = mix["points"], mix["num_inference_steps"]
    slices = mix["slices"]
    plans = [traffic.plan(m, mix["roll_step"], s_inf) for m in slices]
    hooks = Hooks(pc2.backbone, pvd.model)
    noise = Noise(seed, dev)
    rng = random.Random(traffic.stream(seed, 11))

    def slice_call(milestones, roll):
        return bdm_blending(pc2, pvd, batch, num_points=n,
                            milestones=milestones, roll_step=roll,
                            noise=noise, num_inference_steps=s_inf)

    slice_call(*WARMUP)
    noise.carry = None
    common.sync(dev)
    setup_s = time.perf_counter() - t0
    log(f"{cell.name}: set-up {setup_s:.3f} s (kernel build or load "
        f"{build_s:.3f} s); a cycle of {len(slices)} slices holds "
        f"{sum(p.count('pc2') for p in plans)} PC2 steps, "
        f"{sum(p.count('pvd') for p in plans)} PVD steps and "
        f"{sum(len(p.blends) for p in plans)} blends")

    records: List[SliceRecord] = []
    order = mix.get("window", list(range(len(slices))))
    last = [None]           # the position of the slice that ran last

    def one_slice(pos: int, rec: Optional[SliceRecord]):
        p = plans[pos]
        noise.keep = set()
        if rec is not None:
            pc2f, pvdf = p.of("pc2"), p.of("pvd")
            noise.keep = ({_key(pc2f[k]) for k in rec.want_pc2}
                          | {_key(pvdf[k]) for k in rec.want_pvd}
                          | {("mask", b[0]) for b in rec.blends})
        noise.kept, noise.masks = {}, 0
        if last[0] != pos - 1:
            noise.carry = None
        hooks.begin(rec)
        out = slice_call(slices[pos], mix["roll_step"])
        if rec is not None:
            rec.kept = noise.kept
            rec.counts = (hooks.n_pc2, hooks.n_pvd, noise.masks)
            rec.initial = noise.first
            rec.out = out
        noise.carry, last[0] = out, pos
        return p

    steps = 0
    with harness.quiet_host():
        marks = [time.perf_counter()]
        for pos in order:
            rec = choose(plans[pos], rng)
            records.append(rec)
            steps += traffic.steps_of(one_slice(pos, rec))
            common.sync(dev)
            marks.append(time.perf_counter())
    window_s = marks[-1] - marks[0]
    slice_runs = len(records)
    by_slice = [round((b - a) * 1e3 / traffic.steps_of(r.plan), 3)
                for a, b, r in zip(marks, marks[1:], records)]
    log(f"{cell.name}: ms a step by slice {list(order)}: {by_slice}")
    memory = common.peak_bytes(dev)

    pc2_net = counting.pvcnn2(cfg["pc2"]["sa_blocks"], cfg["pc2"]["fp_blocks"],
                              3 + cfg["pc2"]["vit"]["embed_dim"],
                              cfg["pc2"]["embed_dim"], n)
    pvd_net = counting.pvcnn2(cfg["pvd"]["sa_blocks"], cfg["pvd"]["fp_blocks"],
                              0, cfg["pvd"]["embed_dim"], n,
                              cfg["pvd"]["use_att"])
    b = mix["batch"]
    f_pc2 = counting.pvcnn2_flops(pc2_net, b)
    f_pvd = counting.pvcnn2_flops(pvd_net, b)
    v = cfg["pc2"]["vit"]
    f_vit = counting.vit_flops(b, cfg["pc2"]["image_size"], v["patch_size"],
                               v["embed_dim"], v["depth"])
    flops = sum(r.plan.count("pc2") * f_pc2 + r.plan.count("pvd") * f_pvd
                + f_vit for r in records)
    bf16 = cfg["precision"] == "bf16"
    outcome = Outcome(
        kind="sample", setup_s=setup_s, window_s=window_s, steps=steps,
        flops=flops,
        end_to_end={"sample_step_ms": window_s / steps * 1e3,
                    "setup_s": setup_s},
        checks=[], attempted=0, memory_peak_bytes=memory,
        bound_s_per_step=counting.bound_s(
            counting.kernel_launches(pc2_net, b, bf16)),
        peak_flops=counting.PEAK_FLOPS["bf16" if bf16 else "f32"])
    log(f"{cell.name}: window {window_s:.3f} s, {slice_runs} slices, "
        f"{steps} steps, {outcome.end_to_end['sample_step_ms']:.4f} ms a "
        f"step; peak memory {memory} bytes")

    if trace:
        pos = (order[-1] + 1) % len(slices)
        while plans[pos].blends or plans[pos].count("pvd"):
            one_slice(pos, None)
            pos = (pos + 1) % len(slices)
        timed, named = Stretch(), Stretch(host_ops=True)
        a, b = TRACE_FROM, TRACE_FROM + TRACE_STEPS
        hooks.stretches = {a: ("start", timed), b: ("stop", timed),
                           b + 8: ("start", named),
                           b + 8 + TRACE_STEPS: ("stop", named)}
        one_slice(pos, None)
        common.sync(dev)
        hooks.stretches = {}
        own = own_kernels(cell.root)
        outcome.trace = combine(timed.summary(TRACE_STEPS, own),
                                named.summary(TRACE_STEPS, own))
        log(f"{cell.name}: traced {TRACE_STEPS} PC2 steps in "
            f"{timed.wall_s:.4f} s, {named.wall_s:.4f} s with the host's "
            f"operations ({timed.wall_s / TRACE_STEPS * 1e3:.4f} and "
            f"{named.wall_s / TRACE_STEPS * 1e3:.4f} ms a step); "
            f"{outcome.trace.launches} launches; own kernels "
            f"{outcome.trace.own_by_kernel}")

    hooks.close()
    del pc2, pvd, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    outcome.checks, outcome.attempted, outcome.notes["control"] = compare(
        cfg, mix, inputs, sd_pc2, sd_pvd, records, dev, control)
    log(f"{cell.name}: comparison {time.perf_counter() - t:.3f} s")
    return outcome


def _rel(got, want, scale) -> float:
    num = float(torch.linalg.vector_norm((got - want).double()))
    den = float(scale)
    return num / den if den > 0 else math.inf


def compare(cfg, mix, inputs, sd_pc2, sd_pvd, records, dev,
            control: bool):
    """-> (checks, answers compared, the control's checks by precision
    when `control`)."""
    limits = cfg["limits"]
    c = cfg["pc2"]
    ddpm = DDPM(c["beta_start"], c["beta_end"], 1000,
                mix["num_inference_steps"])
    gauss = Gaussian(cfg["pvd"]["beta_start"], cfg["pvd"]["beta_end"])
    with torch.no_grad(), no_tf32():
        ref_pc2 = PC2(c).to(dev).eval()
        ref_pc2.load_state_dict(sd_pc2)
        ref_pvd = PVD(cfg["pvd"]).to(dev).eval()
        ref_pvd.load_state_dict(sd_pvd)
        cam = inputs["camera"]
        runs = {"float32": Run()}
        if control:
            runs.update(fp8=Run(Precision("fp8")),
                        bfloat16=Run(Precision("bfloat16")))
        conds = {k: ref_pc2.conditioning(inputs["image"], r)
                 for k, r in runs.items()}

        def pc2_step(x, t, z, kind="float32"):
            eps = ref_pc2.denoise(x, t, cam, conds[kind], runs[kind])
            return ddpm.step(eps, int(t[0]), x, z), eps

        def pvd_step(x, t, z, kind="float32"):
            eps = ref_pvd.denoise(x, t, runs[kind])
            return gauss.step(eps, int(t[0]), x, z), eps

        names = ("pc2_step", "pvd_step", "blend")
        read = {k: {n: [] for n in names} for k in runs}
        exact, answers, spread = 0, 0, []

        def note(name, got, x_ref, scale, alt):
            read["float32"][name].append(_rel(got, x_ref, scale))
            # the share of the error in the 1 % of points that err most
            d = ((got - x_ref).double() ** 2).sum(-1).flatten()
            top = d.topk(max(1, d.numel() // 100)).values.sum()
            spread.append(round(float(top / d.sum().clamp(min=1e-300)), 3))
            for kind, x in alt.items():
                read[kind][name].append(_rel(x, x_ref, scale))

        for rec in records:
            p = rec.plan
            pc2f, pvdf = p.of("pc2"), p.of("pvd")
            exact += rec.counts != (len(pc2f), len(pvdf), len(p.blends))
            for k, (x, t) in rec.pc2.items():
                exact += bool((t != pc2f[k].t).any())
            for k, (x, t) in rec.pvd.items():
                exact += bool((t != pvdf[k].t).any())
            centred = rec.initial - rec.initial.mean(dim=1, keepdim=True)
            x0 = rec.pc2[0][0]
            exact += not bool(((x0 - centred).abs().max()
                               <= 1e-6 * centred.abs().max()).item())
            exact += not bool(torch.isfinite(rec.out).all())
            answers += 1
            for model, pair, caps, fw, stepf in (
                    [("pc2", k, rec.pc2, pc2f, pc2_step)
                     for k in rec.pc2_pairs]
                    + [("pvd", k, rec.pvd, pvdf, pvd_step)
                       for k in rec.pvd_pairs]):
                x, t = caps[pair]
                z = rec.kept[_key(fw[pair])]
                (x_ref, cc), eps = stepf(x, t, z)
                scale = torch.linalg.vector_norm((cc * eps).double())
                alt = {kind: stepf(x, t, z, kind)[0][0]
                       for kind in runs if kind != "float32"}
                note(f"{model}_step", caps[pair + 1][0], x_ref, scale, alt)
                answers += 1
            for i, r, q, nxt in rec.blends:
                mask = rec.kept[("mask", i)]
                xr, tr = rec.pc2[r]
                xp, tp = rec.pvd[q]
                zr = rec.kept[_key(pc2f[r])]
                zp = rec.kept[_key(pvdf[q])]
                (out_r, cr), eps_r = pc2_step(xr, tr, zr)
                (out_p, cp), eps_p = pvd_step(xp, tp, zp)
                want = blend(out_r, out_p, mask)
                scale = torch.linalg.vector_norm(blend(
                    cr * eps_r, cp * eps_p, mask).double())
                got = rec.pc2[nxt][0] if nxt is not None else rec.out
                alt = {kind: blend(pc2_step(xr, tr, zr, kind)[0][0],
                                   pvd_step(xp, tp, zp, kind)[0][0], mask)
                       for kind in runs if kind != "float32"}
                note("blend", got, want, scale, alt)
                answers += 1
    worst = {k: {n: max(v) if v else math.inf for n, v in r.items()}
             for k, r in read.items()}
    log(f"compared steps: {read['float32']}; the share of each one's error "
        f"in its 1 % of points that err most: {spread}")
    ctrl = {k: checks(v, limits, exact) for k, v in worst.items()
            if k != "float32"}
    if control:
        log(f"control readings: {worst}")
    return checks(worst["float32"], limits, exact), answers, ctrl


def checks(worst: Dict[str, float], limits: dict, exact: int
           ) -> List[Check]:
    """The cell's checks of one set of readings (the program's, or the
    control's in its place)."""
    out = [Check(n, worst[n], limits[n]) for n in worst]
    out.append(Check("exact", float(exact), 0.0))
    return out
