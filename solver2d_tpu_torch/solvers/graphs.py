"""CUDA graphs of the per-world step's XLA solve.

The XLA route runs tens of thousands of small PyTorch kernels a step, and
on the card each costs more host time (~10-25 us to launch) than device
time. Its solve, given the step's `loops.Hints` (the live colors and the
depth of the ordered sums, taken from the host first), syncs with the host
nowhere, so a CUDA graph can hold it: the first step with a given key runs
eagerly, the second captures the solve, and later ones replay it. A key
is the configuration, the device, the current stream, the input shapes and
the hints, so a step whose live colors change runs eagerly once more, and
a graph never replays on a stream other than its own. Replays run the
same kernels on the same inputs as the eager solve, so their results are
equal bit for bit.

Only tensors on a CUDA device take this path; on the CPU the solve runs
eagerly. `ENABLED = False` turns graphs off (eager everywhere).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

ENABLED = True
# graphs kept (least recently used dropped first); each holds its own
# memory pool
MAX_GRAPHS = 8

_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
_seen: set = set()
# a side stream per device to capture on
_capture_streams: dict = {}


def _flatten(tree, out):
    """Tensors of a tree of dataclasses, named tuples, tuples and None, in
    a fixed order; returns a function that rebuilds the tree from such a
    list."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return lambda it: next(it)
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        subs = [_flatten(getattr(tree, n), out) for n in names]
        cls = type(tree)
        return lambda it: cls(**{n: f(it) for n, f in zip(names, subs)})
    if isinstance(tree, tuple):
        subs = [_flatten(x, out) for x in tree]
        cls = type(tree)
        if hasattr(tree, "_fields"):
            return lambda it: cls(*(f(it) for f in subs))
        return lambda it: tuple(f(it) for f in subs)
    raise TypeError(f"cannot flatten {type(tree)}")


class _Graph:
    def __init__(self, fn, args):
        flat = []
        build = _flatten(args, flat)
        self.inputs = [x.clone() for x in flat]
        static_args = build(iter(self.inputs))
        self.graph = torch.cuda.CUDAGraph()
        dev = flat[0].device
        if dev not in _capture_streams:
            _capture_streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.graph(self.graph, stream=_capture_streams[dev]):
            out = fn(*static_args)
        self.outputs = []
        self.rebuild = _flatten(out, self.outputs)
        # an output that is a static input passes the caller's tensor through
        where = {id(x): i for i, x in enumerate(self.inputs)}
        self.passthrough = [where.get(id(x)) for x in self.outputs]

    def __call__(self, args):
        flat = []
        _flatten(args, flat)
        for dst, src in zip(self.inputs, flat):
            dst.copy_(src)
        self.graph.replay()
        outs = [flat[p] if p is not None else x.clone() for x, p in zip(self.outputs, self.passthrough)]
        return self.rebuild(iter(outs))


def run(key, fn, args):
    """fn(*args), through a CUDA graph of it held under `key` when the
    tensors are on a CUDA device: eagerly the first time a key is seen,
    captured the second time, replayed after. fn must not sync with the
    host, and must compute its outputs from `args` only."""
    first = next(iter(x for x in _iter_tensors(args)), None)
    if not ENABLED or first is None or not first.is_cuda:
        return fn(*args)
    # a graph replays on the stream it was made for: two shards of one
    # card (`parallel.sharding`) step on two streams, and one graph's
    # static buffers shared between them would race
    stream = torch.cuda.current_stream(first.device).cuda_stream
    key = (key, first.device, stream, tuple(tuple(x.shape) for x in _iter_tensors(args)))
    graph = _graphs.get(key)
    if graph is None:
        if key not in _seen:
            if len(_seen) > 4096:
                _seen.clear()
            _seen.add(key)
            return fn(*args)
        graph = _Graph(fn, args)
        _graphs[key] = graph
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    return graph(args)


def _iter_tensors(args):
    flat = []
    _flatten(args, flat)
    return flat


def clear():
    """Drop every graph and what was seen (frees their memory pools), and
    the XLA route's widened hints."""
    from .loops import _widened

    _graphs.clear()
    _seen.clear()
    _widened.clear()
