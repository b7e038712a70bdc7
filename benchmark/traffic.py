"""The one generator of the benchmark's traffic: it reads a traffic file
(`benchmark/traffic/<name>.json`) and makes every input of a run from
the run's seed, on the device.

A sampling mix ("kind": "sample") names the batch, the points, the image
size, the camera, the DDPM steps, the roll, the slices of the
production trajectory, and the fixed list of them that a window runs
(`window`, positions in `slices`): a slice that runs just after its
production predecessor starts from that one's output, any other from
fresh noise. A
training mix ("kind": "train") names the batch, the points, the image
size, the camera and the clouds' radius: a fresh batch every step.

`plan` lists the forwards and blends of one slice by the coupled
sampler's rules (`coupled_sampler`: a recon segment between milestones;
at each interior milestone but the first, a recon roll, a prior roll and
a blend or, in BDM-Merging, a fusion step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

MASK64 = 2 ** 63


def stream(seed: int, k: int) -> int:
    """The seed of the run's k-th random stream."""
    return (int(seed) * 1_000_003 + 7919 * k + 1) % MASK64


def generator(seed: int, k: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, k))


def camera(spec: dict, b: int, device) -> dict:
    """R = I, the cloud `distance` ahead, the stated focal length, the
    principal point at the centre."""
    return {
        "R": torch.eye(3, device=device).expand(b, 3, 3).contiguous(),
        "T": torch.tensor([0.0, 0.0, float(spec["distance"])],
                          device=device).expand(b, 3).contiguous(),
        "focal_length": torch.full((b, 2), float(spec["focal_length"]),
                                   device=device),
        "principal_point": torch.zeros(b, 2, device=device),
    }


def images(mix: dict, seed: int, k: int, device) -> torch.Tensor:
    """(B, S, S, 3) uniform in [0, 1]."""
    s = mix["image_size"]
    return torch.rand((mix["batch"], s, s, 3),
                      generator=generator(seed, k, device), device=device)


def sample_inputs(mix: dict, seed: int, device) -> dict:
    return {"image": images(mix, seed, 1, device),
            "camera": camera(mix["camera"], mix["batch"], device)}


def train_batch(mix: dict, seed: int, step: int, device) -> dict:
    """Step `step`'s batch: points uniform on a sphere of `radius`, the
    image uniform in [0, 1]."""
    g = generator(seed, 1000 + step, device)
    b, n, s = mix["batch"], mix["points"], mix["image_size"]
    p = torch.randn((b, n, 3), generator=g, device=device)
    p = float(mix["radius"]) * p / p.norm(dim=-1, keepdim=True)
    image = torch.rand((b, s, s, 3), generator=g, device=device)
    return {"image": image, "camera": camera(mix["camera"], b, device),
            "points": p}


@dataclass(frozen=True)
class Forward:
    model: str          # "pc2" or "pvd"
    branch: str         # "seg", "recon" or "prior"
    i: int              # the milestone index of the sampler's loop
    j: int              # the step within its window
    t: int              # the timestep


@dataclass(frozen=True)
class Plan:
    forwards: List[Forward]
    blends: List[int]   # the milestone indices of the combines, in order

    def count(self, model: str) -> int:
        return sum(f.model == model for f in self.forwards)

    def of(self, model: str) -> List[Forward]:
        return [f for f in self.forwards if f.model == model]


def plan(milestones: Sequence[int], roll: int, steps: int = 1000,
         train_steps: int = 1000, roll_short: int = 0) -> Plan:
    """The forwards and combines of one `coupled_sampler` call over
    `milestones` (DDPM): the rolls stop `roll_short` steps early
    (BDM-Merging's fusion step takes the last one, BDM-Blending's 0)."""
    ratio = train_steps // steps
    ts = [round(k * ratio) for k in range(steps)][::-1]
    m = [int(v) for v in milestones]
    out: List[Forward] = []
    blends: List[int] = []

    def recon(start, end, branch, i):
        for j, t in enumerate(ts[steps - start:steps - end]):
            out.append(Forward("pc2", branch, i, j, t))

    times = len(m) - 1
    for i in range(times):
        if i == 0:
            recon(m[0], m[1] - roll, "seg", i)
        elif i == times - 1:
            recon(m[i] - roll, m[i + 1], "seg", i)
        else:
            recon(m[i] - roll, m[i + 1], "seg", i)
            end = m[i + 1] - roll + roll_short
            recon(m[i + 1], end, "recon", i)
            for j, t in enumerate(range(m[i + 1] - 1, end - 1, -1)):
                out.append(Forward("pvd", "prior", i, j, t))
            blends.append(i)
    return Plan(out, blends)


def steps_of(p: Plan) -> int:
    """Sampler steps of a slice: every network forward with its update (a
    blend rides on the step before it)."""
    return len(p.forwards)
