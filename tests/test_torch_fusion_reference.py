"""The port's BDM-Merging fusion network against the benchmark's plain
reference (`benchmark/reference/fusion.py`), on the CPU at float32 and tiny
widths: the seeded weights of `benchmark/drivers/merging.py` (the towers
PC2's and PVD's draws, the zero-convs live) load into both, and

- `PVCNNFuse` agrees with the reference in both modes within 1e-5 of the
  largest output (float32 sums taken in another order through ~25
  layers), and `BDMMergingModel.nstep_fuse` with the reference's
  `fuse_step` within 1e-4 of ||c eps||, the cell's own reading (the step's
  a x_t term, tens of times c eps at t 984, rounds in the port's order of
  the scheduler's float32 terms);
- each planted fault of the fusion step (the PVD tower fed the recon
  cloud, the projections dropped, the fusion step at the wrong timestep)
  reads above the cell's `fuse_step` limit in a run of the merging driver,
  and the two faults of the PVD tower's part above its `fuse_pvd` limit;
  the reference without its projections is the port without them;
- the driver's hooks over one cycle of the production slices count 995 PC2,
  75 PVD and 5 fusion steps, and keep the mode of each fusion forward
  whether it is passed by position or by keyword;
- the driver's operation count of a fusion forward is the port's own
  count of the layers it runs (`bench.forward_flops`);
- the reference file loads neither JAX, the JAX package nor the port.
"""

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import harness, manifest, traffic
from benchmark.drivers import common, merging
from benchmark.reference import fusion as ref_fusion
from benchmark.reference.diffusion import DDPM
from benchmark.reference.models import PC2
from benchmark.tests import tiny_merging
from bdm_tpu_torch.models.fusion import PVCNNFuse, ZeroConvProj
from bdm_tpu_torch.samplers import BDMMergingModel

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED = 31
# four fusion steps' worth of trajectory at small t, where a step's noise
# and coefficients change fastest with t
SHORT = {"slices": [[60, 50, 40, 30, 20]], "roll_step": 4}
TOL = 1e-5          # the forward, of the largest output
STEP_TOL = 1e-4     # the step, of ||c eps||


class World:
    """The tiny cell's models, port and reference, on one seed's weights."""

    def __init__(self):
        self.cell = tiny_merging.cell()
        cfg = self.cell.config
        sd_pc2 = common.seeded_state("pc2", cfg, SEED, CPU)
        sd_pvd = common.seeded_state("pvd", cfg, SEED, CPU)
        self.sd = merging.fusion_state(cfg, sd_pc2, sd_pvd, SEED, CPU)
        self.merge = merging.merging_program(cfg, CPU)
        self.merge.load_state_dict(merging.merging_state(self.sd, sd_pc2),
                                   strict=True)
        self.ref = merging.fusion_reference(cfg).eval()
        self.ref.load_state_dict(self.sd, strict=True)
        self.ref_pc2 = PC2(cfg["pc2"]).eval()
        self.ref_pc2.load_state_dict(sd_pc2, strict=True)
        mix = self.cell.traffic
        self.inputs = traffic.sample_inputs(mix, SEED, CPU)
        g = torch.Generator().manual_seed(SEED)
        shape = (mix["batch"], mix["points"], 3)
        self.recon, self.prior, self.z = (torch.randn(shape, generator=g)
                                          for _ in range(3))


@pytest.fixture(scope="module")
def world():
    return World()


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_weights_are_the_draws_and_the_zero_convs_live(world):
    f = world.merge.fusion
    for name, p in f.state_dict().items():
        assert torch.equal(p, world.sd[name]), name
    for proj in f.projs:
        assert proj[3].weight.abs().min() > 0


@pytest.mark.parametrize("mode", ref_fusion.MODES)
def test_fusion_forward_matches_the_reference(world, mode):
    x_in = torch.cat([world.recon, torch.randn(
        world.recon.shape[:2] + (world.merge.in_channels - 3,),
        generator=torch.Generator().manual_seed(2))], -1)
    t = torch.tensor([917, 12])
    with torch.no_grad():
        want = world.ref(x_in, world.prior, t, mode)
        got = world.merge.fusion(x_in, world.prior, t, mode)
        other = world.ref(x_in, world.prior, t,
                          next(m for m in ref_fusion.MODES if m != mode))
    assert _rel(got, want) < TOL
    # the modes differ by far more than the tolerance: the PVD tower counts
    assert _rel(other, want) > 1e3 * TOL


def test_nstep_fuse_matches_the_reference_step(world):
    cfg, mix = world.cell.config, world.cell.traffic
    cam = common.camera(world.inputs["camera"])
    cond = world.merge.prepare_cond(
        world.merge.batch_conditioning({"image": world.inputs["image"]}))
    ddpm = DDPM(cfg["pc2"]["beta_start"], cfg["pc2"]["beta_end"], 1000,
                mix["num_inference_steps"])
    ref_cond = world.ref_pc2.conditioning(world.inputs["image"])
    for t in (984, 16):
        got = world.merge.nstep_fuse(world.prior, world.recon, cam, cond, t,
                                     world.z)
        with torch.no_grad():
            (want, c), eps = ref_fusion.fuse_step(
                world.ref, world.ref_pc2, ddpm, world.prior, world.recon, t,
                world.z, world.inputs["camera"], ref_cond)
        reading = float((got - want).norm() / (c * eps).norm())
        assert reading < STEP_TOL, (t, reading)


def _checks():
    """-> the tiny short run's checks by name."""
    cell = tiny_merging.cell(**SHORT)
    out = cell.driver().run(cell, 17, 0.0, False, False, CPU,
                            time.perf_counter())
    return {c.name: c for c in out.checks}


def _fuse_step_reading():
    """-> (the tiny short run's `fuse_step`, its limit)."""
    got = _checks()["fuse_step"]
    return got.value, got.limit


def test_sound_run_reads_far_below_the_limit():
    got = _checks()
    for name in ("fuse_step", "fuse_pvd"):
        assert got[name].value < got[name].limit / 100, got[name]


@pytest.mark.parametrize("fault", ["recon_into_pvd_tower", "no_projections",
                                   "fusion_timestep"])
def test_planted_faults_read_above_the_limit(monkeypatch, fault):
    if fault == "recon_into_pvd_tower":
        inner = PVCNNFuse._forward
        monkeypatch.setattr(PVCNNFuse, "_forward",
                            lambda self, x, prior, t, mode: inner(
                                self, x, prior, t, "fusion_1step"))
    elif fault == "no_projections":
        monkeypatch.setattr(ZeroConvProj, "forward",
                            lambda self, x: torch.zeros_like(x.float()))
    else:
        # the fusion step at its milestone, the roll forgotten
        inner = BDMMergingModel.nstep_fuse
        monkeypatch.setattr(
            BDMMergingModel, "nstep_fuse",
            lambda self, prior, recon, cam, cond, t, *a: inner(
                self, prior, recon, cam, cond, t + SHORT["roll_step"], *a))
    value, limit = _fuse_step_reading()
    assert value > limit


@pytest.mark.parametrize("fault", ["recon_into_pvd_tower", "no_projections"])
def test_planted_pvd_faults_read_above_the_fuse_pvd_limit(monkeypatch,
                                                           fault):
    """`fuse_pvd` reads the PVD tower's part of the step alone: dropping
    it reads 1, feeding the tower the other cloud most of 1."""
    if fault == "recon_into_pvd_tower":
        inner = PVCNNFuse._forward
        monkeypatch.setattr(PVCNNFuse, "_forward",
                            lambda self, x, prior, t, mode: inner(
                                self, x, prior, t, "fusion_1step"))
    else:
        monkeypatch.setattr(ZeroConvProj, "forward",
                            lambda self, x: torch.zeros_like(x.float()))
    got = _checks()["fuse_pvd"]
    assert got.value > got.limit
    if fault == "no_projections":
        assert got.value == pytest.approx(1.0, abs=1e-3)


def test_reference_without_projections_is_the_port_without_them(
        world, monkeypatch):
    x_in = torch.cat([world.recon, torch.randn(
        world.recon.shape[:2] + (world.merge.in_channels - 3,),
        generator=torch.Generator().manual_seed(4))], -1)
    t = torch.tensor([300, 7])
    monkeypatch.setattr(ZeroConvProj, "forward",
                        lambda self, x: torch.zeros_like(x.float()))
    with torch.no_grad():
        want = world.ref(x_in, world.prior, t, project=False)
        got = world.merge.fusion(x_in, world.prior, t)
        full = world.ref(x_in, world.prior, t)
    assert _rel(got, want) < TOL
    assert _rel(full, want) > 1e3 * TOL


def test_hooks_count_one_production_cloud():
    """The merging driver's hooks over one cycle of the port's sampler
    (tiny widths, the production slices) count 995 PC2 forwards, 75 PVD
    forwards and 5 fusion steps."""
    from bdm_tpu_torch.samplers import bdm_merging
    with open(manifest.ROOT / "benchmark" / "traffic"
              / "ddpm1000-b64-ends.json") as f:
        mix = json.load(f)
    c = tiny_merging.cell(slices=mix["slices"])
    cfg = c.config
    pc2 = common.pc2_program(cfg, CPU)
    pvd = common.pvd_program(cfg, CPU)
    merge = merging.merging_program(cfg, CPU)
    sd_pc2 = common.seeded_state("pc2", cfg, 5, CPU)
    sd_pvd = common.seeded_state("pvd", cfg, 5, CPU)
    pc2.load_state_dict(sd_pc2)
    pvd.load_state_dict(sd_pvd)
    merge.load_state_dict(merging.merging_state(
        merging.fusion_state(cfg, sd_pc2, sd_pvd, 5, CPU), sd_pc2))
    inputs = traffic.sample_inputs(c.traffic, 5, CPU)
    batch = {"image": inputs["image"],
             "camera": common.camera(inputs["camera"])}
    hooks = merging.Hooks(pc2.backbone, pvd.model, merge.fusion)
    noise = merging.Noise(5, CPU)
    total = [0, 0, 0]
    for s in c.traffic["slices"]:
        hooks.begin(None)
        noise.carry = bdm_merging(merge, pc2, pvd, batch, num_points=64,
                                  milestones=s, roll_step=16, noise=noise)
        for k, v in enumerate((hooks.n_pc2, hooks.n_pvd, hooks.n_fuse)):
            total[k] += v
    hooks.close()
    assert total == [995, 75, 5]
    plans = [traffic.plan(s, 16, roll_short=1) for s in mix["slices"]]
    window = [plans[k] for k in mix["window"]]
    assert sum(merging.steps_of(p) for p in window) == 299 + 75 + 5


@pytest.mark.parametrize("by", ["position", "keyword"])
def test_hooks_keep_the_mode_however_it_is_passed(world, by):
    """The driver's fusion hook records the mode the program passed, by
    position or by keyword, so `exact` counts a wrong one either way."""
    x_in = torch.cat([world.recon, torch.zeros(
        world.recon.shape[:2] + (world.merge.in_channels - 3,))], -1)
    t = torch.tensor([5, 9])
    hooks = merging.Hooks(torch.nn.Identity(), torch.nn.Identity(),
                          world.merge.fusion)
    rec = types.SimpleNamespace(fuse={})
    hooks.begin(rec)
    with torch.no_grad():
        if by == "position":
            world.merge.fusion(x_in, world.prior, t, "fusion_1step")
        else:
            world.merge.fusion(x_in, world.prior, t, mode="fusion_1step")
        world.merge.fusion(x_in, world.prior, t)
    hooks.close()
    assert [rec.fuse[k][3] for k in (0, 1)] == ["fusion_1step",
                                                "fusion_nstep"]
    assert torch.equal(rec.fuse[0][2], t)


def test_fusion_operations_are_the_ports_count(world):
    from bdm_tpu_torch.bench import forward_flops
    from benchmark import counting
    cfg, mix = world.cell.config, world.cell.traffic
    f, n, b = cfg["fusion"], mix["points"], mix["batch"]
    nets = [counting.pvcnn2(f["sa_blocks"], f["fp_blocks"], extra,
                            f["embed_dim"], n, f["use_att"])
            for extra in (f["extra_feature_channels"], 0)]
    x_in = torch.cat([world.recon, torch.zeros(
        b, n, world.merge.in_channels - 3)], -1)
    fusion = world.merge.fusion
    got = forward_flops(fusion, lambda: fusion(x_in, world.prior,
                                               torch.tensor([5, 9])))
    assert merging.fusion_flops(*nets, b) == got


def test_the_reference_loads_nothing_forbidden():
    code = ("import json, sys; import benchmark.reference.fusion; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "PYTHONPATH": str(manifest.ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert harness.forbidden_modules(mods) == []
    assert not any(m.split(".")[0] == "bdm_tpu_torch" for m in mods)
