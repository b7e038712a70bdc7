"""A run with the timed path broken underneath comes out not correct,
for each fault a cell can have: a step that returns its state unchanged;
half of the batch left out, the rest standing in for it; an answer
altered where it is produced, also in one chain of forwards only. (Every
cell runs on one chip: there is no exchange between chips to leave out.)
The runs skip the look for a chip and drive the rest at tiny widths on
the CPU, with the cells' own limits."""

import time

import pytest
import torch

from benchmark.tests import tiny

CPU = torch.device("cpu")
SHORT = {"slices": [[1000, 990, 980, 970, 960]], "roll_step": 4}


def _correct(cell) -> bool:
    out = cell.driver().run(cell, 17, 0.0, False, False, CPU,
                            time.perf_counter())
    return all(c.ok for c in out.checks)


def _half_batch(forward):
    def broken(self, inputs, t, *args, **kwargs):
        h = inputs.shape[0] // 2
        out = forward(self, inputs[:h], t[:h], *args, **kwargs)
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])
    return broken


def test_sound_short_run_is_correct():
    assert _correct(tiny.cell("sample", **SHORT))
    assert _correct(tiny.cell("train"))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "blend",
                                   "prior_sign", "one_roll"])
def test_sampling_faults(monkeypatch, fault):
    import bdm_tpu_torch.samplers.blending as blending
    from bdm_tpu_torch.diffusion.ddpm import DDPMScheduler
    from bdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from bdm_tpu_torch.models.pvcnn import PVCNN2
    if fault == "unchanged":
        monkeypatch.setattr(DDPMScheduler, "step",
                            lambda self, eps, t, x_t, noise: x_t)
    elif fault == "half_batch":
        monkeypatch.setattr(PVCNN2, "forward", _half_batch(PVCNN2.forward))
    elif fault == "one_roll":
        # the network's part of the step turned round in one chain only:
        # the recon roll before the slice's first blend (t 979 to 976),
        # 4 of its 62 PC2 steps
        inner = DDPMScheduler.step
        monkeypatch.setattr(
            DDPMScheduler, "step",
            lambda self, eps, t, x_t, noise: inner(
                self, -eps if 976 <= int(t) <= 979 else eps, t, x_t, noise))
    elif fault == "blend":
        inner = blending.blend_point_clouds
        monkeypatch.setattr(blending, "blend_point_clouds",
                            lambda a, b, choice: inner(b, a, choice))
    else:
        inner = GaussianDiffusion.p_sample
        monkeypatch.setattr(
            GaussianDiffusion, "p_sample",
            lambda self, fn, x, t, z, clip_denoised=False: inner(
                self, lambda *a: -fn(*a), x, t, z, clip_denoised))
    assert not _correct(tiny.cell("sample", **SHORT))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "loss"])
def test_training_faults(monkeypatch, fault):
    from bdm_tpu_torch.samplers import PC2Model
    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        inner = PC2Model.loss

        def half(self, batch, noise):
            h = batch["points"].shape[0] // 2
            cam = batch["camera"]
            cut = type(cam)(*(getattr(cam, f)[:h] for f in (
                "R", "T", "focal_length", "principal_point")))
            return inner(self, {"image": batch["image"][:h], "camera": cut,
                                "points": batch["points"][:h]}, noise)
        monkeypatch.setattr(PC2Model, "loss", half)
    else:
        inner = PC2Model.loss
        monkeypatch.setattr(PC2Model, "loss",
                            lambda self, b, n: 2.0 * inner(self, b, n))
    assert not _correct(tiny.cell("train"))
