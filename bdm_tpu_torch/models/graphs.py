"""A network's forward replayed as one captured CUDA graph.

A sampler step runs one PVCNN2 forward: some 800 kernels, each launched
by the host on its own. Captured once into a CUDA graph, the same kernels
in the same order are one launch, and the host leaves the step.
`ForwardGraphs` keeps the graphs of one module's forward, one an input
signature (the shape, dtype and device of every tensor argument, None
where an argument is None, and a `key` for what else the forward takes:
the fusion network's mode):

- the first call with a signature runs the forward eagerly, which warms
  the kernels' attributes, the packed conv weights and the allocator,
  then captures it on static input buffers in a private memory pool and
  returns the eager output;
- a later call copies its arguments into the static buffers, replays the
  graph and returns a clone of the static output (a caller may keep an
  output while the next call runs: PNDM's history, the blends);
- the graphs are dropped when a parameter or buffer of the module is
  written in place or replaced (its `data_ptr()` or `_version` changes,
  the rule of `ops.cuda.conv3d.packed`, whose packed weights a graph
  reads), and by `clear()`, which a `Graphed` module calls from `train()`
  and `_apply()` (`.to()`, `.cuda()`, ...).

A call replays only when a replay can stand in for it, as far as the call
can observe (`replayable`): its tensors are on the card, autograd is off
(the samplers run under `inference_mode`), the module is in `eval()`,
spans do not record (a `record_function` cannot fire inside a replay, so
a profile of the spans sees the eager forward), no forward hook sits on a
module inside it or globally (a replay runs no Python, so such a hook
would not fire; the module's own hooks run in `nn.Module.__call__` around
the forward, replayed or not), and no parameter or buffer was made under
`inference_mode` (such a tensor keeps no version, so an in-place write
would go unseen). Every other call runs the forward eagerly.

A replay adds to the kernels' ledger what its capture counted
(`ops.cuda.add_tally`); the capture's own count is taken back, since a
capture runs nothing. `graph_captures` and `graph_replays` count the
graphs captured and the forwards replayed.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.nn as nn
from torch.nn.modules import module as _nn_module

from bdm_tpu_torch.ops import cuda as kernels
from bdm_tpu_torch.utils import spans

# Graphs a module keeps, the least recently used dropped first. A sampler
# runs one signature a network; two serve a caller that alternates between
# two (precontracted PC2 steps and plain ones, a last short batch), and a
# CLI that goes through several batch sizes holds the pools of the latest
# two only: a pool keeps one forward's intermediates, gigabytes at B 64.
MAX_GRAPHS = 2

graph_captures = 0   # graphs captured
graph_replays = 0    # forwards served by a replay


def reset_counts() -> None:
    global graph_captures, graph_replays
    graph_captures = graph_replays = 0


def counts() -> dict:
    return {"graph_captures": graph_captures, "graph_replays": graph_replays}


def _stamp(module: nn.Module) -> Optional[tuple]:
    """(data_ptr, version) of every parameter and buffer of `module`, or
    None when one was made under `inference_mode` (its `_version` raises)
    or a module inside `module` holds a forward hook."""
    stack = list(module._modules.values())
    tensors = [*module._parameters.values(), *module._buffers.values()]
    while stack:
        m = stack.pop()
        if m is None:
            continue
        if m._forward_hooks or m._forward_pre_hooks:
            return None
        tensors += m._parameters.values()
        tensors += m._buffers.values()
        stack += m._modules.values()
    try:
        return tuple((p.data_ptr(), p._version) for p in tensors
                     if p is not None)
    except RuntimeError:
        return None


def _on_card(args) -> bool:
    return all(a is None or a.is_cuda for a in args)


def replayable(module: nn.Module, args) -> bool:
    """The rule's conditions that need no walk over the module: the
    tensors on the card, autograd off, `eval()`, spans off, no global
    forward hook."""
    return (_on_card(args) and not torch.is_grad_enabled()
            and not module.training and not spans.is_recording()
            and not _nn_module._global_forward_hooks
            and not _nn_module._global_forward_pre_hooks)


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: List[Optional[torch.Tensor]]   # static buffers of the arguments
    out: torch.Tensor                      # static output
    tally: dict                       # what one forward adds to the ledger


class ForwardGraphs:
    """The captured graphs of one module's forward (the module
    docstring)."""

    def __init__(self):
        self.graphs = collections.OrderedDict()
        self.stamp = None

    def clear(self) -> None:
        self.graphs.clear()
        self.stamp = None

    def __call__(self, module: nn.Module, fn: Callable, *args, key=None):
        """fn(*args) -> a tensor: eagerly, or by a replay where `module`'s
        forward may be replayed. `key`: what fn depends on besides the
        tensors' signatures (hashable); calls that differ in it never share
        a graph."""
        global graph_replays
        if not replayable(module, args):
            return fn(*args)
        stamp = _stamp(module)
        if stamp is None:
            return fn(*args)
        if stamp != self.stamp:
            self.clear()
            self.stamp = stamp
        sig = tuple(None if a is None else (a.shape, a.dtype, a.device)
                    for a in args) + (key,)
        g = self.graphs.get(sig)
        if g is None:
            out = fn(*args)
            self.graphs[sig] = _capture(fn, args)
            if len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
            return out
        self.graphs.move_to_end(sig)
        for buf, a in zip(g.inputs, args):
            if buf is not None:
                buf.copy_(a)
        g.graph.replay()
        kernels.add_tally(g.tally)
        graph_replays += 1
        return g.out.clone()


class Graphed(nn.Module):
    """A module whose forward goes through its `graphs`: `train()` and
    `_apply()` (`.to()`, `.cuda()`, ...) drop them."""

    def __init__(self):
        super().__init__()
        self.graphs = ForwardGraphs()

    def train(self, mode: bool = True):
        self.graphs.clear()
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)


def _capture(fn: Callable, args) -> _Graph:
    """Capture fn on static buffers shaped like `args`, in a private
    memory pool."""
    global graph_captures
    with torch.inference_mode(False):
        # normal tensors: a later call may copy into them under no_grad
        inputs = [None if a is None else a.clone(
            memory_format=torch.contiguous_format) for a in args]
    before = kernels.tally()
    graph, out = _record(fn, inputs)
    delta = {k: v - before[k] for k, v in kernels.tally().items()
             if v != before[k]}
    kernels.add_tally({k: -d for k, d in delta.items()})
    graph_captures += 1
    return _Graph(graph, inputs, out, delta)


def _record(fn: Callable, inputs):
    """-> (the graph of fn(*inputs), its static output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*inputs)
    return graph, out
