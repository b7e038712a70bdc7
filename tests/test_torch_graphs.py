"""PVCNN2's forward replayed as a captured CUDA graph
(`bdm_tpu_torch.models.graphs`).

On the CPU: the rule that decides when a forward may replay (the CPU,
autograd on, `train()`, an `sp_group`, spans recording, a hook inside the
network or a global one, a parameter made under `inference_mode`: each runs
eagerly and leaves the counters at 0), and the replay's bookkeeping on a
stand-in card, where `_on_card` says yes and a "graph" runs the captured
function again on its static buffers: one capture a signature, the
arguments copied in, a clone handed out, the least recently used graph
dropped past `MAX_GRAPHS`, the graphs dropped by an in-place write,
`train()` and `.to()`, the network's pre-hooks once a call, the kernel
counters' tally. On the card (`-m cuda`): the replay bit for bit the eager
forward for PC2 (390 input channels) and PVD at B 8, N 4096, bf16 and
float32, three timesteps through one graph; outputs kept across calls; an
in-place weight update; pre-hooks; the counters; a B-8 BDM-B tail slice
equal to the eager one. The fusion network's forward (`PVCNNFuse`) under
the same rule: eager on the CPU, one graph a mode, dropped by a write to a
projection, and on the card its replay bit for bit the eager forward in
both modes at production widths. Torch only:

    python -m pytest tests/test_torch_graphs.py -m cuda -q --noconftest
"""

import math

import pytest
import torch
import torch.distributed as dist

from bdm_tpu_torch.models import graphs
from bdm_tpu_torch.models.fusion import MODES, PVCNNFuse
from bdm_tpu_torch.models.layers import get_timestep_embedding
from bdm_tpu_torch.models.pvcnn import PVCNN2
from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.ops.cuda import _lib
from bdm_tpu_torch.parallel import point_sharded as psh
from bdm_tpu_torch.tools.standins import TINY_FP, TINY_SA
from bdm_tpu_torch.utils import spans

torch.set_num_threads(1)

B, N = 2, 64


def _net(extra=5):
    net = PVCNN2(embed_dim=8, extra_feature_channels=extra,
                 sa_blocks=TINY_SA, fp_blocks=TINY_FP,
                 classifier_init_scale=None, dropout=0.0)
    net.reset_parameters(0)
    return net


def _inputs(b=B, c=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, N, c, generator=g) * 0.5,
            torch.tensor([517, 3, 90, 12][:b]))


class _StandInGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the captured
    function again on the static buffers, into the static output."""

    def __init__(self, fn, inputs, out):
        self.fn, self.inputs, self.out = fn, inputs, out

    def replay(self):
        self.out.copy_(self.fn(*self.inputs))


def _stand_in_record(fn, inputs):
    out = fn(*inputs)
    return _StandInGraph(fn, inputs, out), out


@pytest.fixture
def card(monkeypatch):
    """The CPU taken for the card by the rule, with stand-in graphs."""
    monkeypatch.setattr(graphs, "_on_card", lambda args: True)
    monkeypatch.setattr(graphs, "_record", _stand_in_record)
    graphs.reset_counts()
    yield
    graphs.reset_counts()


@pytest.fixture
def one_rank(monkeypatch):
    """An `sp_group` of one rank, without a process group: every level
    runs replicated."""
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(psh, "all_rows", lambda x, group: x)
    monkeypatch.setattr(psh, "own_rows", lambda x, group: x)
    return object()


def _eager(net, x, t):
    with torch.inference_mode():
        return net._forward(x, t, None)


EAGER_CASES = ["cpu", "grad", "train", "sp_group", "spans", "inner_hook",
               "global_hook", "inference_buffer"]


@pytest.mark.parametrize("case", EAGER_CASES)
def test_eager_cases_leave_the_counters_at_zero(case, monkeypatch,
                                                one_rank):
    if case != "cpu":
        monkeypatch.setattr(graphs, "_on_card", lambda args: True)
        monkeypatch.setattr(graphs, "_record", _stand_in_record)
    graphs.reset_counts()
    net = _net()
    x, t = _inputs()
    want = _eager(net, x, t)
    mode = torch.inference_mode()
    handles = []
    if case == "grad":
        mode = torch.enable_grad()
    elif case == "train":
        net.train()
    elif case == "sp_group":
        net.sp_group = one_rank
    elif case == "spans":
        mode = spans.recording()
    elif case == "inner_hook":
        handles.append(net.classifier.register_forward_hook(
            lambda *a: None))
    elif case == "global_hook":
        handles.append(torch.nn.modules.module.register_module_forward_hook(
            lambda *a: None))
    elif case == "inference_buffer":
        with torch.inference_mode():
            net.register_buffer("probe", torch.zeros(1))
    try:
        with mode:
            outs = [net(x, t) for _ in range(3)]
    finally:
        for h in handles:
            h.remove()
    assert graphs.counts() == {"graph_captures": 0, "graph_replays": 0}
    assert not net.graphs.graphs
    for out in outs:
        assert torch.equal(out.detach(), want)


def test_replays_on_a_stand_in_card(card):
    net = _net()
    x, t = _inputs()
    with torch.inference_mode():
        first = net(x, t)
        assert graphs.counts() == {"graph_captures": 1, "graph_replays": 0}
        outs = [net(x * s, t + s) for s in (1, 2, 3)]
    assert graphs.counts() == {"graph_captures": 1, "graph_replays": 3}
    assert torch.equal(first, _eager(net, x, t))
    for s, out in zip((1, 2, 3), outs):
        # a clone of the static output: the next replay leaves it alone
        assert torch.equal(out, _eager(net, x * s, t + s))
    assert len({o.data_ptr() for o in outs}) == 3


def test_one_graph_a_signature_and_at_most_max_graphs(card):
    net = _net()
    with torch.inference_mode():
        for b in (2, 3, 2, 4, 2, 3):
            x, t = _inputs(b)
            assert torch.equal(net(x, t), _eager(net, x, t))
    # captures at 2, 3, 4 (3 dropped), then 3 again
    assert graphs.graph_captures == 4 and graphs.graph_replays == 2
    assert len(net.graphs.graphs) == graphs.MAX_GRAPHS
    assert [k[0][0][0] for k in net.graphs.graphs] == [2, 3]


@pytest.mark.parametrize("change", ["in_place", "load_state_dict", "train",
                                    "to"])
def test_a_change_to_the_module_drops_its_graphs(card, change):
    net = _net()
    x, t = _inputs()
    with torch.inference_mode():
        net(x, t)
        net(x, t)
    assert graphs.counts() == {"graph_captures": 1, "graph_replays": 1}
    if change == "in_place":
        with torch.no_grad():
            net.classifier[2].weight.mul_(3.0)
    elif change == "load_state_dict":
        state = {k: v * 0.5 for k, v in net.state_dict().items()}
        net.load_state_dict(state)
    elif change == "train":
        net.train()
        assert not net.graphs.graphs
        net.eval()
    else:
        net.to(torch.float32)
        assert not net.graphs.graphs
    with torch.inference_mode():
        out = net(x, t)
    assert graphs.counts() == {"graph_captures": 2, "graph_replays": 1}
    assert torch.equal(out, _eager(net, x, t))


def test_pre_hooks_fire_once_a_call(card):
    net = _net()
    x, t = _inputs()
    seen = []
    net.register_forward_pre_hook(lambda m, args: seen.append(args[1][0]))
    with torch.inference_mode():
        net(x, t)                                   # eager, then captured
        for s in range(4):
            net(x, t + s)                           # replays
    with torch.enable_grad():
        net(x, t)                                   # eager
    assert graphs.graph_replays == 4
    assert [int(v) for v in seen] == [517, 517, 518, 519, 520, 517]


def test_a_replay_adds_what_its_capture_counted(card, monkeypatch):
    # the stand-in's forward counts one fps launch a run
    inner = graphs._record

    def counting(fn, inputs):
        def fn_counted(*a):
            _lib.ledger["fps", "launches"] += 1
            return fn(*a)
        return inner(fn_counted, inputs)

    monkeypatch.setattr(graphs, "_record", counting)
    net = _net()
    x, t = _inputs()
    kernels.reset_counts()
    try:
        with torch.inference_mode():
            net(x, t)
            assert kernels.counts()["fps"] == (0, 0)  # a capture runs nothing
            net(x, t)
            net(x, t)
        # each replay: the stand-in's own run and the capture's tally
        assert kernels.counts()["fps"] == (2 * 2, 0)
        kernels.add_tally({k: -v for k, v in kernels.tally().items()})
        assert not any(kernels.tally().values())
    finally:
        kernels.reset_counts()


def test_timestep_frequencies_are_made_once():
    t = torch.tensor([0, 7, 999])
    a = get_timestep_embedding(64, t)
    freq = torch.exp(torch.arange(32, dtype=torch.float64)
                     * -(math.log(10000.0) / 31)).float()
    emb = t.float()[:, None] * freq[None, :]
    assert torch.equal(a, torch.cat([torch.sin(emb), torch.cos(emb)], 1))
    with torch.inference_mode():
        b = get_timestep_embedding(64, t)
    assert torch.equal(a, b)
    # made outside inference mode: usable under autograd afterwards
    w = torch.ones(64, requires_grad=True)
    (get_timestep_embedding(64, t) * w).sum().backward()


def _fuse_net(**kw):
    """A tiny fusion network with its zero-convs drawn live: at zero the
    PVD tower would not reach the output."""
    net = PVCNNFuse(**{"embed_dim": 8, "extra_feature_channels": 5, **kw})
    net.reset_parameters(0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for proj in net.projs:
            w = proj[3].weight
            w.copy_(torch.randn(w.shape, generator=g) / w.shape[1] ** 0.5)
    return net


def _fuse_eager(net, x, prior, t, mode):
    with torch.inference_mode():
        return net._forward(x, prior, t, mode)


def test_fusion_on_the_cpu_runs_eagerly(monkeypatch):
    graphs.reset_counts()
    net = _fuse_net(sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    x, t = _inputs()
    prior = x[..., :3] * 0.7
    with torch.inference_mode():
        # the tensors are off the card, and that alone stops a replay
        assert not graphs.replayable(net, (x, prior, t))
        with monkeypatch.context() as m:
            m.setattr(graphs, "_on_card", lambda args: True)
            assert graphs.replayable(net, (x, prior, t))
        outs = {m: [net(x, prior, t, m) for _ in range(2)] for m in MODES}
    assert graphs.counts() == {"graph_captures": 0, "graph_replays": 0}
    assert not net.graphs.graphs
    for m, got in outs.items():
        for out in got:
            assert torch.equal(out, _fuse_eager(net, x, prior, t, m))


def test_fusion_modes_never_share_a_graph(card):
    net = _fuse_net(sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    x, t = _inputs()
    prior = x[..., :3] * 0.7
    outs = {}
    with torch.inference_mode():
        for m in MODES + MODES:
            outs[m] = net(x, prior, t, m)
            assert torch.equal(outs[m], _fuse_eager(net, x, prior, t, m))
    assert graphs.counts() == {"graph_captures": 2, "graph_replays": 2}
    assert {k[-1] for k in net.graphs.graphs} == set(MODES)
    # the PVD tower reads another cloud in each mode
    assert not torch.equal(*outs.values())


def test_fusion_graphs_drop_on_a_projection_write(card):
    net = _fuse_net(sa_blocks=TINY_SA, fp_blocks=TINY_FP)
    x, t = _inputs()
    prior = x[..., :3] * 0.7
    with torch.inference_mode():
        before = net(x, prior, t)
        net(x, prior, t)
    assert graphs.counts() == {"graph_captures": 1, "graph_replays": 1}
    with torch.no_grad():
        net.projs[1][3].weight.mul_(3.0)
    with torch.inference_mode():
        after = net(x, prior, t)
    assert graphs.counts() == {"graph_captures": 2, "graph_replays": 1}
    assert not torch.equal(after, before)
    assert torch.equal(after, _fuse_eager(net, x, prior, t, "fusion_nstep"))


# ------------------------------------------------------------ on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    graphs.reset_counts()
    return torch.device("cuda")


def _production(kind, dtype, dev):
    from bdm_tpu_torch.models.pvcnn import PVCNN_FP_BLOCKS, PVCNN_SA_BLOCKS
    extra, scale, att = (387, 1e-6, True) if kind == "pc2" else (0, None,
                                                                 True)
    net = PVCNN2(extra_feature_channels=extra, embed_dim=64,
                 use_att=att, sa_blocks=PVCNN_SA_BLOCKS,
                 fp_blocks=PVCNN_FP_BLOCKS, classifier_init_scale=scale,
                 dtype=None if dtype == torch.float32 else dtype)
    net.reset_parameters(3)
    return net.to(dev)


def _card_inputs(net, dev, b=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = 3 + net.specs.sa_in_channels[0]
    x = torch.randn(b, 4096, c, generator=g) * 0.3
    return x.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["pc2", "pvd"])
def test_replay_bit_equal_to_eager(dev, kind, dtype):
    net = _production(kind, dtype, dev)
    x = _card_inputs(net, dev)
    kept = []
    with torch.inference_mode():
        for i, step in enumerate((999, 500, 3)):
            t = torch.full((8,), step, dtype=torch.long, device=dev)
            xi = x * (1.0 + 0.1 * i)
            out = net(xi, t)
            want = net._forward(xi, t, None)
            assert torch.equal(out, want), (kind, dtype, step)
            kept.append((out, want))
    torch.cuda.synchronize()
    assert graphs.counts() == {"graph_captures": 1, "graph_replays": 2}
    # every output kept by the caller is still its own step's
    for out, want in kept:
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_in_place_update_on_the_card(dev):
    net = _production("pvd", torch.bfloat16, dev)
    x = _card_inputs(net, dev, seed=1)
    t = torch.full((8,), 40, dtype=torch.long, device=dev)
    with torch.inference_mode():
        net(x, t)
        before = net(x, t)
    with torch.no_grad():
        for p in net.sa_layers[0][0].voxel_layers[0].parameters():
            p.mul_(1.5)
    with torch.inference_mode():
        after = net(x, t)
        assert not torch.equal(after, before)
        assert torch.equal(after, net._forward(x, t, None))
        assert torch.equal(net(x, t), after)
    assert graphs.counts() == {"graph_captures": 2, "graph_replays": 2}


@pytest.mark.cuda
def test_pre_hooks_and_counters_on_the_card(dev):
    net = _production("pvd", torch.bfloat16, dev)
    x = _card_inputs(net, dev, seed=2)
    calls = []
    net.register_forward_pre_hook(lambda m, args: calls.append(
        args[1][0].item()))
    kernels.reset_counts()
    with torch.inference_mode():
        for step in range(5):
            net(x, torch.full((8,), step, dtype=torch.long, device=dev))
        five = kernels.counts()
        kernels.reset_counts()
        net(x, torch.full((8,), 9, dtype=torch.long, device=dev))
    assert calls == [0, 1, 2, 3, 4, 9]
    assert graphs.counts() == {"graph_captures": 1, "graph_replays": 5}
    # five forwards (one eager, four replays) count five replays' launches
    one = kernels.counts()
    assert five == {k: (5 * a, 5 * b) for k, (a, b) in one.items()}
    assert one["conv3d"][0] > 0 and one["groupnorm"][0] > 0


@pytest.mark.cuda
def test_tail_slice_equal_to_the_eager_one(dev):
    from bdm_tpu_torch.samplers import NoiseProvider, bdm_blending
    from bdm_tpu_torch.tools.standins import camera, production_models
    pc2, pvd, _ = production_models(7)
    g = torch.Generator().manual_seed(8)
    batch = {"image": torch.rand(8, 224, 224, 3, generator=g).to(dev),
             "camera": camera(8, dev)}

    def tail():
        return bdm_blending(pc2, pvd, batch, 4096, [160, 144, 128, 64, 32, 0],
                            16, noise=NoiseProvider(9, dev))

    with spans.recording():         # spans on: every forward eager
        eager = tail()
    assert graphs.counts() == {"graph_captures": 0, "graph_replays": 0}
    replayed = tail()
    assert graphs.graph_captures == 2
    assert graphs.graph_replays == 160 + 48 - 2
    assert torch.equal(replayed, eager)


def test_voxel_run_starts_from_a_search():
    # the run starts as the counts' cumulative sum gave them (bincount
    # reads the largest id on the host, which a CUDA graph cannot hold)
    from bdm_tpu_torch.ops.voxelize import make_voxel_context
    g = torch.Generator().manual_seed(3)
    dup = torch.zeros(2, 50, 3)
    dup[:, 0] = 1.0
    for coords, r in ((torch.randn(3, 500, 3, generator=g), 8),
                      (torch.randn(2, 64, 3, generator=g), 4), (dup, 4)):
        ctx = make_voxel_context(coords, r)
        b = coords.shape[0]
        flat = ctx.ids_sorted.long() + torch.arange(b)[:, None] * r ** 3
        counts = torch.bincount(flat.reshape(-1), minlength=b * r ** 3)
        want = torch.cat([torch.zeros(b, 1, dtype=torch.long),
                          counts.reshape(b, -1).cumsum(1)], 1)
        assert ctx.voxel_lo.dtype == torch.int32
        assert torch.equal(ctx.voxel_lo.long(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_fusion_replay_bit_equal_to_eager(dev, mode):
    """The fusion network at production widths (387 extra channels, bf16),
    B 8, N 4096: three timesteps through one graph, each replay bit for bit
    the eager forward."""
    net = _fuse_net(extra_feature_channels=387, embed_dim=64,
                    dtype=torch.bfloat16).to(dev)
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(8, 4096, 390, generator=g) * 0.3).to(dev)
    prior = (torch.randn(8, 4096, 3, generator=g) * 0.3).to(dev)
    with torch.inference_mode():
        for i, step in enumerate((999, 500, 3)):
            t = torch.full((8,), step, dtype=torch.long, device=dev)
            xi = x * (1.0 + 0.1 * i)
            out = net(xi, prior, t, mode)
            assert torch.equal(out, net._forward(xi, prior, t, mode)), step
    torch.cuda.synchronize()
    assert graphs.counts() == {"graph_captures": 1, "graph_replays": 2}
