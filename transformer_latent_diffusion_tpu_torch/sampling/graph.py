"""The sampler's step loop as one CUDA graph.

The JAX package runs the whole step loop and the final extra denoise as
one `lax.scan` under `jit`, one dispatch (sampling/diffusion.py:421-532).
Its counterpart here is a CUDA graph: the first call for a key runs the
loop eagerly, the second captures it, and every later call with that key
copies its inputs into the graph's static buffers and replays it. A
forward of the fused engine is some sixty host calls (a ctypes wrapper per
kernel, each encoding its TMA tensor maps), so a replay takes the host out
of the loop.

Why the second call captures: a capture records the loop without running
it, then the replay runs it, so a call that captures costs the host's
launches and the device's work one after the other, where an eager call
overlaps them. A key called once (a training eval's new generator, a
request of a shape seen once) runs eagerly and pays nothing for a graph.
The eager call runs on the stream the captures use, so that the capture
needs no warm-up of its own: library loads, kernel attributes and
cuBLAS's workspace for that stream are all made by the eager call.

What the graph holds, and what that asks of its caller:
- Every operand by address. The kernels' TMA tensor maps are encoded on
  the host at capture and frozen into the graph, so every captured
  buffer must stay where it was: the static inputs belong to the entry,
  the loop's intermediates to the graph's private pool, and the weights
  (the engine's prepared weights, or the model's parameters) to the
  caller, who drops the graphs before the weights change
  (`DiffusionGenerator` checks the parameters' versions at each call).
- Only what the key fixes. The key holds the shapes, the route, the
  objective, the step's branch and which guidance options are on; the
  levels, step coefficients, guidance and the options' values are static
  input buffers, so one graph serves DDIM and DPM++ and every schedule.

At most `MAX_GRAPHS` graphs are kept per generator, and at most as many
keys seen once; the least recently used is dropped from each. So many
request shapes cannot grow device memory without end (each graph holds a
private pool of about the loop's working set), and a mix of more keys
than that cycling in turn runs eagerly instead of capturing at every call.

The kernel wrappers count their launches when they are called, which
under capture launches nothing; the counts of the capture are taken back
and added once at each replay, so `LAUNCHES` still counts the kernels that
ran. A capture that fails raises: nothing reruns the loop eagerly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Mapping

import torch

# graphs kept per generator, and keys seen once (least recently used dropped)
MAX_GRAPHS = 8

_STREAMS: Dict[int, Any] = {}  # device index -> the loops' stream


def _loop_stream():
    """The one stream, per device, that every loop's eager first call and
    capture run on: cuBLAS keeps a workspace for each stream it has run
    on, so a new stream per capture would keep one more each time."""
    dev = torch.cuda.current_device()
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream()
    return _STREAMS[dev]


def _launch_counters() -> List[Dict[str, int]]:
    """Every kernel wrapper module's `LAUNCHES` dict."""
    from transformer_latent_diffusion_tpu_torch.ops import (
        attention,
        fused_attn_vjp,
        fused_block,
        fused_layer_vjp,
        fused_mlp_vjp,
        fused_stack,
        fused_stack_f32,
        fused_stack_int8,
        layer_variants,
    )

    return [m.LAUNCHES for m in (attention, fused_attn_vjp, fused_block,
                                 fused_layer_vjp, fused_mlp_vjp, fused_stack,
                                 fused_stack_f32, fused_stack_int8,
                                 layer_variants)]


@dataclass
class _Captured:
    graph: Any  # torch.cuda.CUDAGraph
    fn: Callable[..., torch.Tensor]  # keeps the captured weights alive
    static: Dict[str, torch.Tensor]
    out: torch.Tensor
    launches: List[Dict[str, int]]  # per counter dict: launches a replay


class LoopGraphs:
    """Captured step loops of one generator, keyed by the caller."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._graphs: "OrderedDict[Hashable, _Captured]" = OrderedDict()
        self._seen: "OrderedDict[Hashable, None]" = OrderedDict()
        # one loop at a time: the static buffers are shared by all callers
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        with self._lock:
            self._graphs.clear()
            self._seen.clear()

    def run(self, key: Hashable, fn: Callable[..., torch.Tensor],
            inputs: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """fn(**inputs): eagerly at the first call for `key`, then through
        the graph captured at its second call. Returns a tensor the caller
        owns."""
        with self._lock:
            entry = self._graphs.pop(key, None)
            if entry is None:
                if key not in self._seen:
                    self._remember(self._seen, key, None)
                    return self._eager(fn, inputs)
                del self._seen[key]
                entry = self._capture(fn, inputs)
            self._remember(self._graphs, key, entry)
            for name, t in inputs.items():
                entry.static[name].copy_(t)
            entry.graph.replay()
            for counter, launches in zip(_launch_counters(), entry.launches):
                for name, n in launches.items():
                    counter[name] += n
            self.replays += 1
            return entry.out.clone()

    def _remember(self, table: OrderedDict, key: Hashable, value) -> None:
        while len(table) >= MAX_GRAPHS:
            table.popitem(last=False)
        table[key] = value

    @staticmethod
    def _eager(fn, inputs) -> torch.Tensor:
        side = _loop_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn(**inputs)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def _capture(self, fn, inputs) -> _Captured:
        static = {name: t.clone() for name, t in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        try:
            # thread_local: another thread's CUDA calls (a threaded
            # server's other request) do not invalidate this capture
            with torch.cuda.graph(graph, stream=_loop_stream(),
                                  capture_error_mode="thread_local"):
                out = fn(**static)
            launches = [{name: n - was.get(name, 0)
                         for name, n in counter.items()
                         if n != was.get(name, 0)}
                        for counter, was in zip(counters, before)]
        finally:
            for counter, was in zip(counters, before):
                counter.clear()  # the capture launched nothing
                counter.update(was)
        self.captures += 1
        return _Captured(graph, fn, static, out, launches)
