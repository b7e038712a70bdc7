"""The spans stretch (`benchmark/spans.py`), its four readers and the
tool that runs a cell with it (`benchmark/span_table.py`).

`reduce_spans` on a hand-built trace: nested spans on two threads,
kernels and a copy tied to launches inside and outside them, launches
whose span opened before the stretch began (the profiler keeps no event
of such a span), an idle gap ended inside `network`, a kernel whose
launch is missing and one that starts before its launch. Every figure is
worked out by hand, and the table's launches, device time and idle time
add up exactly to the stretch's, as `trace.reduce` reads the same events.
Then `SpanStretch` itself on a tiny forward: on the CPU, and (marked
`cuda`) on the card, where every device event finds its launch. That no
kernel starts before its launch is not held: on the card's hosts the
profiler's carry of device times onto the host's clock drifts."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import manifest, span_table, trace
from benchmark.spans import NONE, SpanStretch, lines, reduce_spans

STEPS = 2


def _span(tid, name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": a, "dur": b - a}


def _call(tid, ts, corr, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "tid": tid,
            "ts": ts, "dur": 3, "args": {"correlation": corr}}


def _dev(ts, dur, corr, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def _events():
    spans = [_span(1, "network", 100, 400),
             _span(1, "groupnorm", 120, 160),
             _span(1, "pvconv.devoxelize", 200, 260),
             _span(1, "attention", 280, 350),
             _span(1, "groupnorm", 300, 340),
             _span(1, "pc2.update", 420, 460),
             _span(2, "network", 125, 250)]
    calls = [_call(1, 50, 1),             # its span opened before the start
             _call(1, 110, 2), _call(1, 130, 3), _call(2, 130, 9),
             _call(1, 210, 4), _call(1, 220, 5),
             _call(1, 240, 11, "cudaMemcpyAsync"),
             _call(1, 290, 7), _call(1, 310, 6), _call(1, 380, 12),
             _call(1, 430, 8), _call(1, 470, 10),
             _call(1, 480, 13, "cudaStreamSynchronize")]
    dev = [_dev(60, 10, 1), _dev(115, 5, 2), _dev(135, 20, 3),
           _dev(175, 10, 9), _dev(215, 10, 4), _dev(222, 10, 5),
           _dev(245, 5, 11, "gpu_memcpy", "Memcpy DtoD"),
           _dev(295, 10, 7), _dev(312, 8, 6),
           _dev(375, 2, 12),                # starts before its launch
           _dev(440, 10, 8), _dev(480, 10, 10),
           _dev(500, 4, 99)]                # no launch in the trace
    other = [{"ph": "X", "cat": "gpu_user_annotation", "name": "network",
              "tid": 7, "ts": 110, "dur": 300},
             {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler",
              "tid": 0, "ts": 0, "dur": 600},
             {"ph": "s", "cat": "ac2g", "name": "launch", "id": 2, "ts": 110}]
    return spans + calls + dev + other


WANT = {  # name: calls, launches self / incl, device us self / incl,
    #       idle us self / incl
    "network": (2, 3, 8, 17, 80, 120, 230),
    "groupnorm": (2, 2, 2, 28, 28, 22, 22),
    "pvconv.devoxelize": (1, 2, 2, 25, 25, 43, 43),
    "attention": (1, 1, 2, 10, 18, 45, 52),
    "pc2.update": (1, 1, 1, 10, 10, 63, 63),
    NONE: (0, 2, 2, 24, 24, 40, 40),
}


def test_reduce_spans_by_hand():
    t = reduce_spans(_events(), STEPS)
    got = {k: (r["calls"], r["launches_self"], r["launches"],
               r["device_us_self"], r["device_us"], r["idle_us_self"],
               r["idle_us"]) for k, r in t["rows"].items()}
    assert got == WANT
    assert (t["launches"], t["device_us"], t["idle_us"], t["calls"]) == \
        (11, 114, 333, 7)
    assert (t["unmatched"], t["early"], t["lead_us"]) == (1, 1, 5)
    assert len(lines(t)) == len(WANT) + 2


def test_the_table_adds_up_to_the_stretch():
    ev = _events()
    t = reduce_spans(ev, STEPS)
    rows = t["rows"].values()
    s = trace.reduce(ev, STEPS, 600e-6, set())
    assert sum(r["launches_self"] for r in rows) == t["launches"] \
        == s.launches
    dev = [e for e in ev if e.get("cat") in trace.DEVICE_CATS]
    assert sum(r["device_us_self"] for r in rows) == t["device_us"] \
        == sum(e["dur"] for e in dev)
    first = min(e["ts"] for e in dev)
    last = max(e["ts"] + e["dur"] for e in dev)
    assert sum(r["idle_us_self"] for r in rows) == t["idle_us"] \
        == pytest.approx(last - first - s.busy_s * 1e6, abs=1e-9)


def test_the_four_readers():
    o = SimpleNamespace(kind="sample",
                        notes={"spans": reduce_spans(_events(), STEPS)})
    got = {k: read(o) for k, read in span_table.readers().items()}
    assert got == pytest.approx({"devoxelize_ms.sample": 25e-3 / STEPS,
                                 "groupnorm_ms.sample": 28e-3 / STEPS,
                                 "sampler_launches.sample": 3 / STEPS,
                                 "forward_idle_ms.sample": 230e-3 / STEPS})


def test_readers_read_nothing_without_spans():
    """A run without the spans stretch, a program without spans (its table
    holds `(none)` alone), and a training outcome."""
    no_spans = [e for e in _events() if e["cat"] != "user_annotation"]
    t = reduce_spans(no_spans, STEPS)
    assert set(t["rows"]) == {NONE} and t["rows"][NONE]["launches"] == 11
    for o in (SimpleNamespace(kind="sample", notes={}),
              SimpleNamespace(kind="sample", notes={"spans": t}),
              SimpleNamespace(kind="train", notes={
                  "spans": reduce_spans(_events(), STEPS)})):
        assert all(read(o) is None
                   for read in span_table.readers().values())


def test_the_tool_takes_the_named_stretch():
    """`span_table` puts a spans stretch where the cell's driver takes a
    stretch with the host's operations: its summary is `trace.reduce`'s
    over the same events, and it keeps the table by span."""
    driver = manifest.load("bdmb-ddpm1000-b64").driver()
    assert driver.Stretch is trace.Stretch
    assert type(span_table.stretch()) is trace.Stretch
    s = span_table.stretch(host_ops=True)
    assert isinstance(s, SpanStretch) and span_table.NamedSpans.made[-1] is s
    s.events, s.wall_s = _events(), 600e-6
    got = s.summary(STEPS, set())
    assert got == trace.reduce(_events(), STEPS, 600e-6, set())
    assert {n for n, _ in got.idle_gaps} <= {"no host op",
                                             "no launch found"}
    want = reduce_spans(_events(), STEPS)
    want["wall_s"] = 600e-6
    assert s.spans == want and s.events is None


def _tiny_pvcnn2(dev):
    from bdm_tpu_torch.models.pvcnn import PVCNN2
    from benchmark.tests.tiny import FP, SA
    net = PVCNN2(embed_dim=16, extra_feature_channels=0, sa_blocks=SA,
                 fp_blocks=FP, classifier_init_scale=None)
    net.reset_parameters(0)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 64, 3, generator=g) * 0.5).to(dev)
    return net.to(dev), x, torch.tensor([517, 3], device=dev)


def test_span_stretch_on_the_cpu():
    net, x, t = _tiny_pvcnn2(torch.device("cpu"))
    stretch = SpanStretch()
    with torch.no_grad():
        net(x, t)
        stretch.start()
        net(x, t)
        net(x, t)
        stretch.stop()
        net(x, t)
    table = stretch.table(2)
    assert table["rows"]["network"]["calls"] == 2
    assert table["rows"]["groupnorm"]["calls"] == 2 * sum(
        type(m).__name__ == "GroupNormCL" for m in net.modules())
    assert table["wall_s"] > 0 and table["device_us"] == 0


@pytest.mark.cuda
def test_span_stretch_on_the_card(card):
    from benchmark.drivers import common
    common.build_kernels(card)
    net, x, t = _tiny_pvcnn2(card)
    stretch = SpanStretch()
    with torch.inference_mode():
        net(x, t)
        stretch.start()
        for _ in range(3):
            net(x, t)
        stretch.stop()
    table = stretch.table(3)
    rows = table["rows"].values()
    assert table["unmatched"] == 0
    assert table["rows"]["network"]["calls"] == 3
    assert table["rows"]["network"]["launches"] == table["launches"] > 0
    assert sum(r["launches_self"] for r in rows) == table["launches"]
    assert sum(r["device_us_self"] for r in rows) == pytest.approx(
        table["device_us"], rel=1e-9)
    assert table["rows"]["pvconv.devoxelize"]["device_us"] > 0
