"""BDM-Merging sampling over slices of the production trajectory.

The window calls the port's `bdm_merging` once a slice, over the fixed list
of slices the traffic names, as `blending.py`'s window calls
`bdm_blending`: the same work in every run whatever the program's speed,
a slice after its production predecessor from that one's output, any
other from fresh noise, the device waited for at the end of each slice.
The rolls stop one step short of `milestone - roll` (`traffic.plan(...,
roll_short=1)`) and one fusion step takes the last: the fusion network's
forward over both branches' clouds and one DDPM step. A step is a network
forward with its scheduler update, so PC2, PVD and fusion steps all count.
The warm-up runs every signature the window runs, the fusion's included,
so no CUDA graph is captured inside the window.

What the timed path produced is held to the reference (`reference/`,
`reference/fusion.py`) from the program's own state, as in `blending.py`:

  pc2_step, pvd_step   ||x_prog - x_ref|| / ||c eps_ref|| over one step
                       of every chain of forwards drawn from the seed, and
                       over the last step of each roll, whose output the
                       fusion step reads re-centred; the largest of the run;
  fuse_step            the same over EVERY fusion step of the window: the
                       re-centred recon and prior clouds the program fed
                       the fusion forward and the noise it drew, through
                       the reference's `fuse_step` at the plan's timestep,
                       against the input of the PC2 forward after it (the
                       slice's output where none follows);
  fuse_pvd             over the same fusion steps, the part of the step
                       the PVD tower decides through the projections,
                       d = x_ref - x_ref(projections left out): the
                       program's departure along it, |<x_prog - x_ref, d>|
                       / ||d||^2; 0 where the program has the PVD tower's
                       part, 1 where it has none of it. `fuse_step` sees
                       that part only as a few hundredths of the step;
  exact                mismatches of what is fixed: each slice's forwards
                       and fusions against the plan, the compared steps'
                       and every fusion's timesteps and mode, each slice's
                       first input against its centred initial cloud,
                       finite outputs.

With `--trace 1`, after the window: `outcome.trace` covers 12 PC2 steps of
a middle slice, as in `blending.py`; a second traced stretch
(`notes["fusion"]`) covers one fusion step as the window runs it
(`nstep_fuse`, its forward replayed where the program captures it); and a
spans stretch (`notes["spans"]`) covers the same step eagerly, with the
program's spans recording.
"""

from __future__ import annotations

import dataclasses
import math
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import counting, harness, traffic, weights
from benchmark.drivers import blending, common
from benchmark.harness import Outcome
from benchmark.reference import fusion as ref_fusion
from benchmark.reference.diffusion import DDPM, Gaussian
from benchmark.reference.models import PC2, PVD
from benchmark.reference.precision import Precision, no_tf32
from benchmark.reference.pvcnn import Run
from benchmark.spans import SpanStretch
from benchmark.trace import Stretch, combine, own_kernels

# milestones, roll: every signature of the window, each network replayed
# at least once (two fusion steps)
WARMUP = ([1000, 996, 990, 984, 982], 2)
TOWERS = (("pc2", "point_cloud_model.model."), ("pvd", "model."))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Noise(blending.Noise):
    """`blending.Noise` with the fusion step's noise, kept when the slice's
    record asks for ("fuse", i)."""

    def fuse(self, i, shape):
        z = torch.randn(shape, generator=self.gen, device=self.dev)
        if ("fuse", i) in self.keep:
            self.kept[("fuse", i)] = z
        return z


@dataclass
class SliceRecord:
    plan: traffic.Plan
    milestones: List[int]
    pc2_pairs: List[int]
    pvd_pairs: List[int]
    # per fusion: (milestone index, last recon roll forward, last prior
    # roll forward, the PC2 forward after it or None)
    fusions: List[Tuple[int, int, int, Optional[int]]]
    want_pc2: set
    want_pvd: set
    pc2: Dict[int, tuple] = field(default_factory=dict)
    pvd: Dict[int, tuple] = field(default_factory=dict)
    fuse: Dict[int, tuple] = field(default_factory=dict)
    kept: Dict[tuple, torch.Tensor] = field(default_factory=dict)
    counts: Tuple[int, int, int] = (0, 0, 0)
    initial: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None


def choose(p: traffic.Plan, milestones, rng: random.Random) -> SliceRecord:
    """One step of every chain of PC2 and PVD forwards drawn from the run's
    seed, each with the input of the forward after it; every fusion, with
    the two roll steps before it and the PC2 forward after it."""
    pc2, pvd = p.of("pc2"), p.of("pvd")
    a = [rng.choice(c) for c in blending._chains(pc2)]
    v = [rng.choice(c) for c in blending._chains(pvd)]
    want_pc2 = {0} | set(a) | {k + 1 for k in a}
    want_pvd = set(v) | {k + 1 for k in v}
    fusions = []
    for i in p.blends:
        r = max(k for k, f in enumerate(pc2)
                if f.branch == "recon" and f.i == i)
        q = max(k for k, f in enumerate(pvd) if f.i == i)
        nxt = r + 1 if r + 1 < len(pc2) else None
        fusions.append((i, r, q, nxt))
        want_pc2 |= {r} | ({nxt} if nxt is not None else set())
        want_pvd |= {q}
    return SliceRecord(p, [int(m) for m in milestones], a, v, fusions,
                       want_pc2, want_pvd)


class Hooks(blending.Hooks):
    """`blending.Hooks` and a pre-hook on the fusion network: it counts the
    slice's fusion forwards and keeps, of each, the recon and prior clouds,
    the timesteps and the mode."""

    def __init__(self, pc2_net, pvd_net, fusion_net):
        super().__init__(pc2_net, pvd_net)
        self.n_fuse = 0
        self.handles.append(fusion_net.register_forward_pre_hook(
            self._fuse, with_kwargs=True))

    def begin(self, rec) -> None:
        super().begin(rec)
        self.n_fuse = 0

    def _fuse(self, mod, args, kwargs):
        k = self.n_fuse
        self.n_fuse += 1
        if self.rec is not None:
            mode = args[3] if len(args) > 3 else kwargs.get("mode",
                                                            "fusion_nstep")
            self.rec.fuse[k] = (args[0][..., :3].clone(),
                                args[1][..., :3].clone(), args[2].clone(),
                                mode)


def fusion_state(cfg: dict, sd_pc2: dict, sd_pvd: dict, seed: int,
                 dev) -> dict:
    """The fusion network's weights under the fusion checkpoint's keys:
    the towers the PC2 and PVD draws' encoders, the rest (decoder,
    `embedf`, classifier, projections, zero-convs live) drawn by
    `weights.state_dict`'s rule from stream 4 of the seed."""
    with torch.device("meta"):
        shape = fusion_reference(cfg)
    own = weights.state_dict(shape, seed, 4, dev)
    out = {k: v for k, v in own.items()
           if not k.startswith(("pc2_model_", "pvd_model_"))}
    for (kind, prefix), sd in zip(TOWERS, (sd_pc2, sd_pvd)):
        for part in ("sa_layers.", "global_att."):
            for k, v in sd.items():
                if k.startswith(prefix + part):
                    out[f"{kind}_model_{part}{k[len(prefix + part):]}"] = v
    return out


def fusion_reference(cfg: dict) -> ref_fusion.PVCNNFuse:
    f = cfg["fusion"]
    return ref_fusion.PVCNNFuse(f["sa_blocks"], f["fp_blocks"],
                                f["extra_feature_channels"], f["embed_dim"],
                                3, f["use_att"], f["dropout"])


def merging_program(cfg: dict, dev):
    """The port's `BDMMergingModel`: PC2's conditioning configuration, the
    fusion network's blocks."""
    from bdm_tpu_torch.samplers import BDMMergingModel, ProjectionConfig
    c, f = cfg["pc2"], cfg["fusion"]
    pcfg = ProjectionConfig(
        image_size=c["image_size"],
        image_feature_model=c["image_feature_model"],
        raster_point_radius=c["raster_point_radius"],
        beta_start=c["beta_start"], beta_end=c["beta_end"],
        point_cloud_model_embed_dim=f["embed_dim"],
        mixed_precision=cfg["precision"])
    return BDMMergingModel(pcfg, sa_blocks=common.blocks(f["sa_blocks"]),
                           fp_blocks=common.blocks(f["fp_blocks"]),
                           vit_kwargs=c["vit"], device=dev,
                           dropout=f["dropout"])


def merging_state(sd_fuse: dict, sd_pc2: dict) -> dict:
    """`BDMMergingModel`'s state: the fusion network's and, for its
    feature model, PC2's."""
    out = {f"fusion_model.model.{k}": v for k, v in sd_fuse.items()}
    out.update({k: v for k, v in sd_pc2.items()
                if k.startswith("feature_model.")})
    return out


def fusion_flops(pc2_net: counting.Net, pvd_net: counting.Net,
                 b: int) -> int:
    """One fusion forward by `counting.py`'s rules: `embedf`, PC2's tower
    and decoder (a PVCNN2 forward), PVD's tower, and the projections (three
    dense layers each on the PVD tower's skip features and bottleneck)."""
    e = pvd_net.embed
    tower = dataclasses.replace(pvd_net, fp=(), head=(0, 0, 0, 0))
    proj = sum(3 * 2 * b * m * widths[-1] * widths[-1]
               for _, (n, m, radius, k, cin, widths) in pvd_net.sa)
    return (counting.pvcnn2_flops(pc2_net, b)
            + counting.pvcnn2_flops(tower, b) - 2 * 2 * b * e * e + proj)


def steps_of(p: traffic.Plan) -> int:
    """Sampler steps of a slice: its forwards and its fusion steps."""
    return len(p.forwards) + len(p.blends)


def run(cell, seed: int, seconds: float, trace: bool, control: bool, dev,
        t0: float) -> Outcome:
    from bdm_tpu_torch.samplers import bdm_merging
    cfg, mix = cell.config, cell.traffic
    build_s = common.build_kernels(dev)
    sd_pc2 = common.seeded_state("pc2", cfg, seed, dev)
    sd_pvd = common.seeded_state("pvd", cfg, seed, dev)
    sd_fuse = fusion_state(cfg, sd_pc2, sd_pvd, seed, dev)
    pc2 = common.pc2_program(cfg, dev)
    pvd = common.pvd_program(cfg, dev)
    merge = merging_program(cfg, dev)
    pc2.load_state_dict(sd_pc2)
    pvd.load_state_dict(sd_pvd)
    merge.load_state_dict(merging_state(sd_fuse, sd_pc2))
    inputs = traffic.sample_inputs(mix, seed, dev)
    batch = {"image": inputs["image"],
             "camera": common.camera(inputs["camera"])}
    n, s_inf, roll = mix["points"], mix["num_inference_steps"], \
        mix["roll_step"]
    slices = mix["slices"]
    plans = [traffic.plan(m, roll, s_inf, roll_short=1) for m in slices]
    hooks = Hooks(pc2.backbone, pvd.model, merge.fusion)
    noise = Noise(seed, dev)
    rng = random.Random(traffic.stream(seed, 11))

    def slice_call(milestones, roll_step):
        return bdm_merging(merge, pc2, pvd, batch, num_points=n,
                           milestones=milestones, roll_step=roll_step,
                           noise=noise, num_inference_steps=s_inf)

    slice_call(*WARMUP)
    noise.carry = None
    common.sync(dev)
    setup_s = time.perf_counter() - t0
    log(f"{cell.name}: set-up {setup_s:.3f} s (kernel build or load "
        f"{build_s:.3f} s); a cycle of {len(slices)} slices holds "
        f"{sum(p.count('pc2') for p in plans)} PC2 steps, "
        f"{sum(p.count('pvd') for p in plans)} PVD steps and "
        f"{sum(len(p.blends) for p in plans)} fusion steps")

    records: List[SliceRecord] = []
    order = mix.get("window", list(range(len(slices))))
    last = [None]           # the position of the slice that ran last

    def one_slice(pos: int, rec: Optional[SliceRecord]):
        p = plans[pos]
        noise.keep = set()
        if rec is not None:
            pc2f, pvdf = p.of("pc2"), p.of("pvd")
            noise.keep = ({blending._key(pc2f[k]) for k in rec.want_pc2}
                          | {blending._key(pvdf[k]) for k in rec.want_pvd}
                          | {("fuse", f[0]) for f in rec.fusions})
        noise.kept = {}
        if last[0] != pos - 1:
            noise.carry = None
        hooks.begin(rec)
        out = slice_call(slices[pos], roll)
        if rec is not None:
            rec.kept = noise.kept
            rec.counts = (hooks.n_pc2, hooks.n_pvd, hooks.n_fuse)
            rec.initial = noise.first
            rec.out = out
        noise.carry, last[0] = out, pos
        return p

    steps = 0
    with harness.quiet_host():
        marks = [time.perf_counter()]
        for pos in order:
            rec = choose(plans[pos], slices[pos], rng)
            records.append(rec)
            steps += steps_of(one_slice(pos, rec))
            common.sync(dev)
            marks.append(time.perf_counter())
    window_s = marks[-1] - marks[0]
    by_slice = [round((b - a) * 1e3 / steps_of(r.plan), 3)
                for a, b, r in zip(marks, marks[1:], records)]
    log(f"{cell.name}: ms a step by slice {list(order)}: {by_slice}")
    memory = common.peak_bytes(dev)

    pc2_net = counting.pvcnn2(cfg["pc2"]["sa_blocks"], cfg["pc2"]["fp_blocks"],
                              3 + cfg["pc2"]["vit"]["embed_dim"],
                              cfg["pc2"]["embed_dim"], n)
    pvd_net = counting.pvcnn2(cfg["pvd"]["sa_blocks"], cfg["pvd"]["fp_blocks"],
                              0, cfg["pvd"]["embed_dim"], n,
                              cfg["pvd"]["use_att"])
    f = cfg["fusion"]
    fuse_pc2 = counting.pvcnn2(f["sa_blocks"], f["fp_blocks"],
                               f["extra_feature_channels"], f["embed_dim"], n,
                               f["use_att"])
    fuse_pvd = counting.pvcnn2(f["sa_blocks"], f["fp_blocks"], 0,
                               f["embed_dim"], n, f["use_att"])
    b = mix["batch"]
    f_pc2 = counting.pvcnn2_flops(pc2_net, b)
    f_pvd = counting.pvcnn2_flops(pvd_net, b)
    f_fuse = fusion_flops(fuse_pc2, fuse_pvd, b)
    v = cfg["pc2"]["vit"]
    f_vit = counting.vit_flops(b, cfg["pc2"]["image_size"], v["patch_size"],
                               v["embed_dim"], v["depth"])
    flops = sum(r.plan.count("pc2") * f_pc2 + r.plan.count("pvd") * f_pvd
                + len(r.plan.blends) * f_fuse + f_vit for r in records)
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
    log(f"{cell.name}: window {window_s:.3f} s, {len(records)} slices, "
        f"{steps} steps, {outcome.end_to_end['sample_step_ms']:.4f} ms a "
        f"step; peak memory {memory} bytes; a fusion forward "
        f"{f_fuse / 1e9:.1f} GFLOP, a PC2 forward {f_pc2 / 1e9:.1f}")

    if trace:
        pos = (order[-1] + 1) % len(slices)
        while plans[pos].blends or plans[pos].count("pvd"):
            one_slice(pos, None)
            pos = (pos + 1) % len(slices)
        timed, named = Stretch(), Stretch(host_ops=True)
        steps_traced = blending.TRACE_STEPS
        a = blending.TRACE_FROM
        e = a + steps_traced
        hooks.stretches = {a: ("start", timed), e: ("stop", timed),
                           e + 8: ("start", named),
                           e + 8 + steps_traced: ("stop", named)}
        one_slice(pos, None)
        common.sync(dev)
        hooks.stretches = {}
        own = own_kernels(cell.root)
        outcome.trace = combine(timed.summary(steps_traced, own),
                                named.summary(steps_traced, own))
        outcome.notes["fusion"], outcome.notes["spans"] = trace_fusion(
            merge, pc2, batch, records, s_inf, own)
        fs = outcome.notes["fusion"]
        log(f"{cell.name}: traced {steps_traced} PC2 steps in "
            f"{timed.wall_s:.4f} s ({timed.wall_s / steps_traced * 1e3:.4f} "
            f"ms a step), {outcome.trace.launches} launches; own kernels "
            f"{outcome.trace.own_by_kernel}; one fusion step: device "
            f"{fs.busy_s * 1e3:.4f} ms in {fs.wall_s * 1e3:.4f} ms, "
            f"{fs.launches} launches")

    hooks.close()
    del pc2, pvd, merge, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    outcome.checks, outcome.attempted, outcome.notes["control"] = compare(
        cfg, mix, inputs, sd_pc2, sd_pvd, sd_fuse, records, dev, control)
    log(f"{cell.name}: comparison {time.perf_counter() - t:.3f} s")
    return outcome


def trace_fusion(merge, pc2, batch, records, s_inf, own):
    """One fusion step as the window runs it (`nstep_fuse` on the last
    fusion's inputs), traced: -> (its `trace.Summary`, the spans table of
    the same step run again with the spans recording, so eagerly)."""
    rec = next(r for r in reversed(records) if r.fuse)
    k = max(rec.fuse)
    recon, prior, t, _ = rec.fuse[k]
    i = rec.fusions[k][0]
    z = rec.kept[("fuse", i)]
    cond = pc2.prepare_cond(pc2.batch_conditioning(batch))

    def step():
        return merge.nstep_fuse(prior, recon, batch["camera"], cond,
                                int(t[0]), z, "ddpm", s_inf)

    step()
    timed = Stretch()
    timed.start()
    step()
    timed.stop()
    spans = SpanStretch()
    spans.start()
    step()
    spans.stop()
    return timed.summary(1, own), spans.table(1)


def _along(x, x_ref, d) -> float:
    """|<x - x_ref, d>| / ||d||^2: the share of d that x departs from x_ref
    by (inf where d is 0, where no departure can show)."""
    dd = float((d * d).sum())
    if dd == 0.0:
        return math.inf
    return abs(float(((x.double() - x_ref.double()) * d).sum())) / dd


def compare(cfg, mix, inputs, sd_pc2, sd_pvd, sd_fuse, records, dev,
            control: bool):
    """-> (checks, answers compared, the control's checks by precision
    when `control`)."""
    limits = cfg["limits"]
    c = cfg["pc2"]
    roll = mix["roll_step"]
    ddpm = DDPM(c["beta_start"], c["beta_end"], 1000,
                mix["num_inference_steps"])
    gauss = Gaussian(cfg["pvd"]["beta_start"], cfg["pvd"]["beta_end"])
    with torch.no_grad(), no_tf32():
        ref_pc2 = PC2(c).to(dev).eval()
        ref_pc2.load_state_dict(sd_pc2)
        ref_pvd = PVD(cfg["pvd"]).to(dev).eval()
        ref_pvd.load_state_dict(sd_pvd)
        ref_fuse = fusion_reference(cfg).to(dev).eval()
        ref_fuse.load_state_dict(sd_fuse)
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

        def fuse_step(recon, prior, t, z, kind="float32", project=True):
            return ref_fusion.fuse_step(ref_fuse, ref_pc2, ddpm, prior, recon,
                                        t, z, cam, conds[kind], runs[kind],
                                        project)

        names = ("pc2_step", "pvd_step", "fuse_step", "fuse_pvd")
        read = {k: {n: [] for n in names} for k in runs}
        exact, answers = 0, 0

        def note(name, got, x_ref, scale, alt):
            read["float32"][name].append(blending._rel(got, x_ref, scale))
            for kind, x in alt.items():
                read[kind][name].append(blending._rel(x, x_ref, scale))

        def centred(x):
            return x - x.mean(dim=1, keepdim=True)

        for rec in records:
            p = rec.plan
            pc2f, pvdf = p.of("pc2"), p.of("pvd")
            exact += rec.counts != (len(pc2f), len(pvdf), len(p.blends))
            exact += sorted(rec.fuse) != list(range(len(rec.fusions)))
            for k, (x, t) in rec.pc2.items():
                exact += bool((t != pc2f[k].t).any())
            for k, (x, t) in rec.pvd.items():
                exact += bool((t != pvdf[k].t).any())
            x0 = rec.pc2[0][0]
            start = centred(rec.initial)
            exact += not bool(((x0 - start).abs().max()
                               <= 1e-6 * start.abs().max()).item())
            exact += not bool(torch.isfinite(rec.out).all())
            answers += 1
            for model, pair, caps, fw, stepf in (
                    [("pc2", k, rec.pc2, pc2f, pc2_step)
                     for k in rec.pc2_pairs]
                    + [("pvd", k, rec.pvd, pvdf, pvd_step)
                       for k in rec.pvd_pairs]):
                x, t = caps[pair]
                z = rec.kept[blending._key(fw[pair])]
                (x_ref, cc), eps = stepf(x, t, z)
                scale = torch.linalg.vector_norm((cc * eps).double())
                alt = {kind: stepf(x, t, z, kind)[0][0]
                       for kind in runs if kind != "float32"}
                note(f"{model}_step", caps[pair + 1][0], x_ref, scale, alt)
                answers += 1
            for k, (i, r, q, nxt) in enumerate(rec.fusions):
                if k not in rec.fuse:
                    continue
                recon, prior, t, mode = rec.fuse[k]
                t_plan = rec.milestones[i + 1] - roll
                exact += bool((t != t_plan).any()) + (mode != "fusion_nstep")
                # the rolls' last steps, re-centred as the fusion reads them
                for model, x_t, z, stepf, got in (
                        ("pc2", rec.pc2[r], rec.kept[blending._key(pc2f[r])],
                         pc2_step, recon),
                        ("pvd", rec.pvd[q], rec.kept[blending._key(pvdf[q])],
                         pvd_step, prior)):
                    (x_ref, cc), eps = stepf(*x_t, z)
                    scale = torch.linalg.vector_norm((cc * eps).double())
                    alt = {kind: centred(stepf(*x_t, z, kind)[0][0])
                           for kind in runs if kind != "float32"}
                    note(f"{model}_step", got, centred(x_ref), scale, alt)
                    answers += 1
                z = rec.kept[("fuse", i)]
                (x_ref, cc), eps = fuse_step(recon, prior, t_plan, z)
                scale = torch.linalg.vector_norm((cc * eps).double())
                got = rec.pc2[nxt][0] if nxt is not None else rec.out
                alt = {kind: fuse_step(recon, prior, t_plan, z, kind)[0][0]
                       for kind in runs if kind != "float32"}
                note("fuse_step", got, x_ref, scale, alt)
                (x_np, _), _ = fuse_step(recon, prior, t_plan, z,
                                         project=False)
                d = (x_ref - x_np).double()
                for kind, x in {"float32": got, **alt}.items():
                    read[kind]["fuse_pvd"].append(_along(x, x_ref, d))
                answers += 1
    worst = {k: {n: max(v) if v else math.inf for n, v in r.items()}
             for k, r in read.items()}
    log(f"compared steps: {read['float32']}")
    ctrl = {k: blending.checks(v, limits, exact) for k, v in worst.items()
            if k != "float32"}
    if control:
        log(f"control readings: {worst}")
    return blending.checks(worst["float32"], limits, exact), answers, ctrl
