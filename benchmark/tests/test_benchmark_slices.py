"""The slices of the traffic tile one production cloud: every forward at
its production timestep, in production order, and per cycle 1,000 PC2
steps, 80 PVD steps and 5 blends (BDM-Merging: 995, 75 and 5 fusion
steps)."""

import json

import pytest
import torch

from benchmark import manifest, traffic
from benchmark.tests import tiny

MIXES = ["ddpm1000-b8", "ddpm1000-b32", "ddpm1000-b64"]
# each mix's window: (PC2 steps, PVD steps, blends, steps)
WINDOWS = {"ddpm1000-b8": (565, 80, 5, 645),
           "ddpm1000-b32": (565, 80, 5, 645),
           "ddpm1000-b64": (391, 80, 5, 471)}


def _mix(name):
    with open(manifest.ROOT / "benchmark" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _sequence(plans):
    """(model, t, in a roll) of every forward, in order."""
    return [(f.model, f.t, f.branch != "seg") for p in plans
            for f in p.forwards]


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("short, want", [(0, (1000, 80, 5)),
                                         (1, (995, 75, 5))])
def test_slices_tile_the_production_cloud(name, short, want):
    mix = _mix(name)
    plans = [traffic.plan(s, mix["roll_step"], mix["num_inference_steps"],
                          roll_short=short) for s in mix["slices"]]
    whole = traffic.plan(mix["milestones"], mix["roll_step"],
                         mix["num_inference_steps"], roll_short=short)
    got = (sum(p.count("pc2") for p in plans),
           sum(p.count("pvd") for p in plans),
           sum(len(p.blends) for p in plans))
    assert got == want
    assert (whole.count("pc2"), whole.count("pvd"), len(whole.blends)) \
        == want
    assert _sequence(plans) == _sequence([whole])


@pytest.mark.parametrize("name", MIXES)
def test_the_window_is_a_fixed_list(name):
    """Every run's window does the same work: the tail slice from fresh
    noise, then the head and middles after it."""
    mix = _mix(name)
    assert mix["window"][:2] == [9, 0]
    plans = [traffic.plan(mix["slices"][k], mix["roll_step"],
                          mix["num_inference_steps"]) for k in mix["window"]]
    assert (sum(p.count("pc2") for p in plans),
            sum(p.count("pvd") for p in plans),
            sum(len(p.blends) for p in plans),
            sum(traffic.steps_of(p) for p in plans)) == WINDOWS[name]


def test_slice_sizes():
    mix = _mix("ddpm1000-b8")
    steps = [traffic.steps_of(traffic.plan(s, 16)) for s in mix["slices"]]
    assert steps == [176] + [87] * 8 + [208]
    assert sum(steps) == 1080


def test_hooks_count_one_production_cloud():
    """The harness's own hooks over one cycle of the port's sampler (tiny
    widths, the production slices) count 1,000 PC2 forwards, 80 PVD
    forwards and 5 blends."""
    from bdm_tpu_torch.samplers import bdm_blending
    from benchmark.drivers import blending, common
    c = tiny.cell("sample", slices=_mix("ddpm1000-b8")["slices"])
    dev = torch.device("cpu")
    pc2 = common.pc2_program(c.config, dev)
    pvd = common.pvd_program(c.config, dev)
    pc2.load_state_dict(common.seeded_state("pc2", c.config, 5, dev))
    pvd.load_state_dict(common.seeded_state("pvd", c.config, 5, dev))
    inputs = traffic.sample_inputs(c.traffic, 5, dev)
    batch = {"image": inputs["image"],
             "camera": common.camera(inputs["camera"])}
    hooks = blending.Hooks(pc2.backbone, pvd.model)
    noise = blending.Noise(5, dev)
    total = [0, 0, 0]
    for s in c.traffic["slices"]:
        hooks.begin(None)
        noise.masks = 0
        noise.carry = bdm_blending(pc2, pvd, batch, num_points=64,
                                   milestones=s, roll_step=16, noise=noise)
        for k, v in enumerate((hooks.n_pc2, hooks.n_pvd, noise.masks)):
            total[k] += v
    hooks.close()
    assert total == [1000, 80, 5]
