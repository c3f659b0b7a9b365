"""CUDA graphs of a loop body: the port's stand-in for ``jax.jit`` on the
body of a ``lax.while_loop``.

The JAX package compiles generation into one program whose loop runs on
the device. PyTorch runs eagerly, one launch per operation, so a decode
step of a few hundred small launches is bound by the host. Here the step
is captured once as a ``torch.cuda.CUDAGraph`` over static buffers (the
step reads and writes only tensors allocated before the capture) and then
replayed: one launch a step.

:class:`StepGraph` captures a step function after warming it up on a side
stream, as PyTorch's graph docs require, restoring the caller's state and
the generator's afterwards so that the first replay is the first step.
It keeps ``kernels.LAUNCHES`` true: the kernel wrappers count in Python,
so a capture counts each kernel once and a replay not at all; the runner
takes back the capture's counts (nothing ran) and adds them on every
replay. :class:`GraphCache` keeps a few captured steps with their buffers,
keyed by everything that shapes them, least recently used first out.
``CAPTURES`` counts the captures of the process and their wall seconds
(the warm-up step and the capture, synchronised), so that a caller can
tell what a cache miss cost, and the hits of :class:`GraphCache`.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional

import torch

from probing_rag_tpu_torch import kernels

# captures made (each a GraphCache miss or a new loop), their seconds, and
# the GraphCache hits
CAPTURES: Dict[str, float] = {"count": 0, "seconds": 0.0, "hits": 0}


class StepGraph:
    """A step function captured as a CUDA graph.

    ``step()`` must read and write only tensors that outlive the graph and
    keep their addresses (its static buffers), and must not read the
    host. ``save()`` returns what ``restore(saved)`` puts back: the
    buffers the warm-up steps changed. ``generator``, when the step draws
    random numbers from it, is registered with the graph, so each replay
    advances it as an eager step would. A capture that fails raises."""

    def __init__(self, step: Callable[[], None], save: Callable[[], object],
                 restore: Callable[[object], None], *, generator: Optional[torch.Generator] = None,
                 warmup: int = 1):
        t0 = time.perf_counter()
        saved = save()
        rng = generator.get_state() if generator is not None else None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                step()
        torch.cuda.current_stream().wait_stream(side)
        restore(saved)
        if generator is not None:
            generator.set_state(rng)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = dict(kernels.LAUNCHES)
        with torch.cuda.graph(self.graph):
            step()
        # the capture launched nothing: its counts move to the replays
        self.launches: Dict[str, int] = {}
        for name, n in kernels.LAUNCHES.items():
            if n != before[name]:
                self.launches[name] = n - before[name]
                kernels.LAUNCHES[name] = before[name]
        torch.cuda.current_stream().synchronize()
        CAPTURES["count"] += 1
        CAPTURES["seconds"] += time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n


class GraphCache:
    """At most ``size`` entries (a captured step with its static buffers),
    least recently used evicted first: each entry holds a KV cache and a
    graph memory pool, so a loop whose prompts fall in several length
    buckets must not keep one per bucket forever."""

    def __init__(self, size: int):
        self.size = size
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()

    def get(self, key: Hashable, make: Callable[[], object]):
        if key in self._entries:
            self._entries.move_to_end(key)
            CAPTURES["hits"] += 1
            return self._entries[key]
        while len(self._entries) >= self.size:
            self._entries.popitem(last=False)
        entry = self._entries[key] = make()
        return entry

    def clear(self) -> None:
        self._entries.clear()


class StaticState:
    """The tensors a step reads and writes, as attributes, allocated once.
    ``MUTABLE`` names those a step changes: :meth:`save` and
    :meth:`restore` put them back around a graph's warm-up."""

    MUTABLE: tuple = ()

    def save(self) -> list:
        return [getattr(self, name).clone() for name in self.MUTABLE]

    def restore(self, saved: list) -> None:
        for name, value in zip(self.MUTABLE, saved):
            getattr(self, name).copy_(value)


class Loop:
    """A step over a :class:`StaticState`, run eagerly (``graphed``
    False: each call launches the step's operations) or captured once and
    replayed, and the host's check between steps (:func:`all_finished`,
    through a pinned flag and an event on the card). ``generator`` is the
    loop's own: a graph stays registered with the generator it captured,
    so the caller's generator state is copied in and out around each run
    (:meth:`run`)."""

    def __init__(self, state: StaticState, device: torch.device, *, graphed: bool,
                 sampling: bool = False):
        self.state = state
        self.graphed = graphed
        self.graph: Optional[StepGraph] = None
        self.steps = self.checks = 0
        self.generator = torch.Generator(device=device) if graphed and sampling else None
        self.flag = self.event = None
        if device.type == "cuda":
            self.flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()

    def run(self, step: Callable[[Optional[torch.Generator]], None], done: Callable[[], torch.Tensor],
            max_steps: int, check_every: int, generator: Optional[torch.Generator] = None) -> int:
        """Runs ``step(generator)`` at most ``max_steps`` times, first
        asking the device whether ``done()`` (a bool tensor) is all true,
        then again after every ``check_every`` steps; stops when it is.
        Returns the steps run. Steps past the point where it became true
        must change no output (the step's own contract)."""
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        gen = generator
        if self.graphed and self.generator is not None:
            self.generator.set_state(generator.get_state())
            gen = self.generator

        def go():
            if not self.graphed:
                step(gen)
                return
            if self.graph is None:  # captured at the first step a call runs
                self.graph = StepGraph(lambda: step(gen), self.state.save, self.state.restore,
                                       generator=gen)
            self.graph.replay()

        n = checks = 0
        while n < max_steps:
            checks += 1
            if all_finished(done(), self.flag, self.event):
                break
            for _ in range(min(check_every, max_steps - n)):
                go()
                n += 1
        if self.graphed and self.generator is not None:
            generator.set_state(self.generator.get_state())
        self.steps, self.checks = n, checks  # the last run's, for measurements
        return n


# the captured steps of the process (decode and speculative rounds)
GRAPHS = GraphCache(4)


def tree_key(tree, prefix: str = "") -> tuple:
    """(path, address, shape, dtype) of every tensor of a nested dict: a
    captured graph reads its inputs at fixed addresses, so a cached graph
    may serve a call only if every one of them is where it was."""
    out = []
    for name, v in tree.items():
        if isinstance(v, dict):
            out.extend(tree_key(v, f"{prefix}{name}/"))
        else:
            out.append((prefix + name, v.data_ptr(), tuple(v.shape), v.dtype))
    return tuple(out)


def all_finished(done: torch.Tensor, flag: Optional[torch.Tensor] = None,
                 event: Optional[torch.cuda.Event] = None) -> bool:
    """Whether every entry of the bool tensor ``done`` is true: the host's
    check between replays (the counterpart of the JAX loop's ``cond``). On
    the card the reduction is copied without blocking into the pinned
    0-dim ``flag`` and the host waits on ``event`` for that copy alone."""
    if flag is None:
        return bool(done.all())
    flag.copy_(done.all(), non_blocking=True)
    event.record()
    event.synchronize()
    return bool(flag)
