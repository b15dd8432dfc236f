"""CUDA Graphs: capture a launch DAG once, replay it as one launch.

CUDA amortizes per-launch host work by recording a stream's work into a
graph (``cudaStreamBeginCapture`` .. ``cudaStreamEndCapture``),
instantiating it (``cudaGraphInstantiate``) and replaying the whole DAG
with one ``cudaGraphLaunch``.  Here a :class:`~repro_torch.core.streams
.Stream`'s capture records kernel launches, h2d/d2d copies, device heap
updates and event record/wait edges into a :class:`Graph`;
:meth:`Graph.instantiate` makes a :class:`GraphExec`:

* on the card, it records the nodes, in order, into one
  ``torch.cuda.CUDAGraph`` on a capture stream of its own.  The heap's
  tensors are the graph's static inputs and outputs - every node writes
  them in place (kernels through :func:`repro_torch.core.lower_cuda
  .in_place`, updates and copies with ``copy_``) - and a replay is one
  ``graph.replay()``, with no Python per node;
* on the CPU, a replay walks the same nodes in order over the heap.

Dependence edges come from the same hazard model as the eager stream
runtime (paper Listing 4, extended stream-to-stream):

* program order within each captured stream (CUDA stream semantics);
* RAW/WAW/WAR over global buffers - a kernel's write set is its declared
  ``KernelDef.writes``; its read set is ``KernelDef.reads`` when declared,
  else conservatively the whole heap at capture time;
* explicit ``event.record(s0)`` / ``s1.wait_event(event)`` pairs captured
  on streams of the same graph (``cudaStreamWaitEvent`` inside capture).

Nodes in one topological level (:meth:`Graph.levels`) have no path
between them.  The card's capture records them all on one stream, in node
order; forking independent levels onto streams of their own is later
work (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import api, lower_cuda
from repro_torch.core import memory as memory_mod
from repro_torch.core.backends import get_backend
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import KernelDef
from repro_torch.core.lower_shard import DEFAULT_AXIS


class GraphError(RuntimeError):
    """Invalid capture or replay (the cudaErrorStreamCapture* family)."""


@dataclasses.dataclass
class GraphNode:
    """One captured operation.

    ``kind`` is ``"kernel"`` | ``"h2d"`` | ``"d2d"`` | ``"update"`` |
    ``"event_record"`` | ``"event_wait"``; event nodes carry ordering
    only and execute nothing at replay.  ``deps`` are indices of nodes
    that must precede this one (always smaller than ``idx``, so node
    order is already topological).  An ``h2d`` node copies ``host`` (a
    tensor) onto ``buffer``; ``d2d`` copies heap buffer ``src`` onto
    ``buffer``; ``update`` applies the pure heap function ``fn`` (a
    captured :meth:`Stream.device_update`).
    """

    idx: int
    kind: str
    stream: str
    deps: tuple[int, ...]
    label: str
    # kernel fields
    kernel: KernelDef | None = None
    grid: Dim3 | None = None
    block: Dim3 | None = None
    backend: str = "vector"
    grain: int = 1
    dyn_shared: int | None = None
    interpret: bool = True
    devices: int | None = None
    shard_axis: str = DEFAULT_AXIS
    reads: tuple[str, ...] = ()
    writes: tuple[str, ...] = ()
    # h2d / d2d fields
    buffer: str | None = None
    host: Any = None
    src: str | None = None
    # update fields
    fn: Callable | None = None


def write_back(heap: dict, outs: dict) -> None:
    """Write each of ``outs`` into the heap's tensor of that name, in
    place (a name the heap lacks is added).

    Every new value is settled before any is written: one that shares
    storage with a heap tensor - a ping-pong's ``{"src": bufs["dst"],
    "dst": zeros}`` - is cloned first, so writing one buffer cannot change
    another's new value.  A value must keep its buffer's shape and dtype
    (CUDA's byte-count rule): the buffer's address is what a captured
    graph replays over."""
    held = {memory_mod.unwrap(v).untyped_storage().data_ptr()
            for v in heap.values()}
    settled = {}
    for name, value in outs.items():
        cur = heap.get(name)
        cur = None if cur is None else memory_mod.unwrap(cur, "write")
        if value is cur:
            continue
        if cur is not None and (cur.shape != value.shape
                                or cur.dtype != value.dtype):
            raise GraphError(
                f"heap buffer {name!r} is ({tuple(cur.shape)}, {cur.dtype}); "
                f"an update of ({tuple(value.shape)}, {value.dtype}) cannot "
                f"be written in place")
        if value.untyped_storage().data_ptr() in held:
            value = value.clone()
        settled[name] = (cur, value)
    for name, (cur, value) in settled.items():
        if cur is None:
            heap[name] = value
        else:
            cur.copy_(value, non_blocking=True)


class Graph:
    """A captured DAG of launches/memcpys/updates/events (a
    ``cudaGraph_t``)."""

    def __init__(self):
        self.nodes: list[GraphNode] = []
        self.device: torch.device | None = None   # the capturing streams'
        self._last_writer: dict[str, int] = {}
        self._readers: dict[str, set[int]] = {}
        self._stream_tail: dict[str, int] = {}
        self._streams: list[Any] = []          # attached capturing streams
        # the buffers the nodes write and read, kept as nodes commit: a
        # capture asks for them at every node, and a chain's unit holds
        # thousands
        self._written: set[str] = set()
        self._read: set[str] = set()

    # -- capture plumbing (called by Stream/Runtime) -------------------------
    def _attach(self, stream) -> None:
        if stream not in self._streams:
            self._streams.append(stream)
        if self.device is None:
            self.device = stream.device

    def _detach(self, stream) -> None:
        if stream in self._streams:
            self._streams.remove(stream)

    def _ordered_deps(self, stream_name: str, reads, writes) -> set[int]:
        deps: set[int] = set()
        tail = self._stream_tail.get(stream_name)
        if tail is not None:                   # stream program order
            deps.add(tail)
        for b in reads:                        # RAW
            if b in self._last_writer:
                deps.add(self._last_writer[b])
        for b in writes:                       # WAW + WAR
            if b in self._last_writer:
                deps.add(self._last_writer[b])
            deps.update(self._readers.get(b, ()))
        return deps

    def _commit(self, node: GraphNode) -> GraphNode:
        self.nodes.append(node)
        for b in node.writes:
            self._last_writer[b] = node.idx
            self._readers[b] = set()
        for b in node.reads:
            self._readers.setdefault(b, set()).add(node.idx)
        self._stream_tail[node.stream] = node.idx
        self._written.update(node.writes)
        self._read.update(node.reads)
        return node

    def written(self) -> set[str]:
        """Buffers any node writes (kernel writes, copy targets, updates)."""
        return set(self._written)

    def touched(self) -> set[str]:
        return self._written | self._read

    def add_kernel(self, stream, kernel: KernelDef, *, grid, block,
                   backend: str = "vector", grain=1,
                   dyn_shared: int | None = None, interpret: bool = True,
                   pool: int | None = None, devices: int | None = None,
                   shard_axis: str = DEFAULT_AXIS,
                   optimize: bool | None = None) -> GraphNode:
        grid, block = Dim3.of(grid), Dim3.of(block)
        if api._optimize_enabled(optimize):
            # barrier fission happens at CAPTURE time: the node stores the
            # derived kernel, so every replay runs the fused stages.  The
            # analysis needs concrete buffer values; a kernel whose inputs
            # are first produced inside the graph (not yet on the heap) is
            # captured unoptimized rather than analyzed on garbage.
            needed = set(kernel.writes) | set(
                kernel.reads if kernel.reads is not None
                else stream.buffers)
            if needed <= set(stream.buffers):
                kernel = api._optimized(
                    kernel, grid, block,
                    {n: stream.buffers[n] for n in sorted(needed)},
                    dyn_shared, True)
        heap_names = set(stream.buffers) | self.written()
        if kernel.reads is not None:
            missing = set(kernel.reads) - heap_names
            if missing:
                raise GraphError(
                    f"capture on stream {stream.name!r}: kernel "
                    f"{kernel.name} reads {sorted(missing)} which exist "
                    f"neither on the heap nor earlier in the graph")
            reads = tuple(kernel.reads)
        else:                   # undeclared reads: order after everything
            reads = tuple(sorted(heap_names))
        writes = tuple(kernel.writes)
        grain = api._resolve_grain(kernel, grain, pool, grid.size)
        idx = len(self.nodes)
        node = GraphNode(
            idx=idx, kind="kernel", stream=stream.name,
            deps=tuple(sorted(self._ordered_deps(stream.name, reads,
                                                 writes))),
            label=f"{kernel.name}[{tuple(grid)},{tuple(block)}]@{backend}",
            kernel=kernel, grid=grid, block=block, backend=backend,
            grain=grain, dyn_shared=dyn_shared, interpret=interpret,
            devices=devices, shard_axis=shard_axis,
            reads=reads, writes=writes)
        return self._commit(node)

    def add_h2d(self, stream, buffer: str, host: torch.Tensor) -> GraphNode:
        idx = len(self.nodes)
        node = GraphNode(
            idx=idx, kind="h2d", stream=stream.name,
            deps=tuple(sorted(self._ordered_deps(stream.name, (),
                                                 (buffer,)))),
            label=f"h2d:{buffer}", buffer=buffer, host=host,
            writes=(buffer,))
        return self._commit(node)

    def add_d2d(self, stream, dst: str, src: str) -> GraphNode:
        """Capture a device-to-device copy between named heap buffers."""
        known = set(stream.buffers) | self.written()
        if src not in known:
            raise GraphError(
                f"capture on stream {stream.name!r}: d2d source {src!r} "
                f"exists neither on the heap nor earlier in the graph")
        idx = len(self.nodes)
        node = GraphNode(
            idx=idx, kind="d2d", stream=stream.name,
            deps=tuple(sorted(self._ordered_deps(stream.name, (src,),
                                                 (dst,)))),
            label=f"d2d:{src}->{dst}", buffer=dst, src=src,
            reads=(src,), writes=(dst,))
        return self._commit(node)

    def add_update(self, stream, fn, writes: tuple) -> GraphNode:
        """Capture an on-device heap update (Stream.device_update).

        The update reads the whole heap (its signature is the full buffer
        dict), so it orders conservatively after every prior writer.
        """
        heap_names = tuple(sorted(set(stream.buffers) | self.written()))
        idx = len(self.nodes)
        node = GraphNode(
            idx=idx, kind="update", stream=stream.name,
            deps=tuple(sorted(self._ordered_deps(stream.name, heap_names,
                                                 tuple(writes)))),
            label=f"update:{','.join(writes)}", fn=fn,
            reads=heap_names, writes=tuple(writes))
        return self._commit(node)

    def add_event_record(self, stream, event) -> GraphNode:
        idx = len(self.nodes)
        node = GraphNode(
            idx=idx, kind="event_record", stream=stream.name,
            deps=tuple(sorted(self._ordered_deps(stream.name, (), ()))),
            label=f"record:{event.name}")
        event._capture = (self, idx)
        return self._commit(node)

    def add_event_wait(self, stream, event) -> GraphNode:
        cap = getattr(event, "_capture", None)
        if cap is None or cap[0] is not self:
            raise GraphError(
                f"stream {stream.name!r} cannot wait on event "
                f"{event.name!r}: it was not recorded during this capture "
                f"(record it on a stream captured into the same graph)")
        deps = self._ordered_deps(stream.name, (), ()) | {cap[1]}
        idx = len(self.nodes)
        node = GraphNode(idx=idx, kind="event_wait", stream=stream.name,
                         deps=tuple(sorted(deps)),
                         label=f"wait:{event.name}")
        return self._commit(node)

    # -- structure -----------------------------------------------------------
    def levels(self) -> list[list[int]]:
        """Topological levels: nodes in one level are mutually independent."""
        depth: dict[int, int] = {}
        out: list[list[int]] = []
        for n in self.nodes:
            d = 1 + max((depth[i] for i in n.deps), default=-1)
            depth[n.idx] = d
            while len(out) <= d:
                out.append([])
            out[d].append(n.idx)
        return out

    def summary(self) -> str:
        lines = [f"graph: {len(self.nodes)} nodes, "
                 f"{len(self.levels())} levels"]
        for lvl, idxs in enumerate(self.levels()):
            labels = ", ".join(self.nodes[i].label for i in idxs)
            lines.append(f"  level {lvl}: {labels}")
        return "\n".join(lines)

    def instantiate(self, buffers: dict | None = None) -> "GraphExec":
        """Make the DAG replayable (``cudaGraphInstantiate``).  With
        ``buffers`` it is checked against that heap now - and on the card
        captured over its tensors; otherwise at the first replay."""
        if self._streams:
            raise GraphError(
                "instantiate() during capture: call end_capture() first "
                f"(streams still capturing: "
                f"{[s.name for s in self._streams]})")
        ex = GraphExec(self)
        if buffers is not None:
            ex.validate(buffers)
        return ex


class GraphExec:
    """An instantiated graph over a buffer heap.

    ``replay(buffers)`` runs every node over the heap's tensors, in place,
    and returns the written buffers; on the card it is one
    ``torch.cuda.CUDAGraph`` replay, captured at the first replay (or at
    ``instantiate(buffers)``) over that heap's tensors.  A later heap
    whose tensor for a buffer is another one of the same shape and dtype
    has its values copied into the captured tensor first.
    ``launch(stream)`` is ``cudaGraphLaunch``: it orders the replay after
    in-flight foreign writers of touched buffers (the eager runtime's
    hazard rule), replays on the stream, and marks the written buffers
    pending there.

    A replay adds, to each hand-written kernel's ``launches`` count, the
    launches the capture recorded for it; the capture itself launches
    nothing and counts nothing.
    """

    def __init__(self, graph: Graph):
        self.graph = graph
        self.written = tuple(sorted(graph.written()))
        self.launches = 0
        # heap inputs: every touched buffer that is not first produced
        # inside the graph itself
        produced: set[str] = set()
        needed: set[str] = set()
        for n in graph.nodes:
            needed.update(b for b in n.reads if b not in produced)
            needed.update(b for b in n.writes
                          if n.kind == "kernel" and b not in produced)
            produced.update(n.writes)
        self.inputs = tuple(sorted(needed))
        self._host = [n.host for n in graph.nodes if n.kind == "h2d"]
        # the card's capture: the CUDA graph, the tensors it was captured
        # over, the h2d sources it copies from, and launches per replay
        self._cuda_graph = None
        self._static: dict[str, torch.Tensor] = {}
        self._staged: list[torch.Tensor] = []
        self._counts: list[tuple[Any, int]] = []
        self._done = None          # the last replay's end, on the card

    def _heap(self, buffers: dict) -> dict:
        missing = [b for b in self.inputs if b not in buffers]
        if missing:
            raise GraphError(
                f"graph replay needs buffer(s) {missing} on the heap")
        # ConstArray/DeviceBuffer heap entries unwrap (liveness-checked)
        return {b: memory_mod.unwrap(buffers[b], "graph replay")
                for b in self.graph.touched() if b in buffers}

    def _device(self, heap: dict) -> torch.device:
        devices = {t.device for t in heap.values()}
        if len(devices) > 1:
            raise GraphError(f"graph replay over a heap on several devices: "
                             f"{sorted(str(d) for d in devices)}")
        if devices:
            return devices.pop()
        if self.graph.device is None:
            raise GraphError("graph replay: no heap tensor and no capturing "
                             "stream to take a device from")
        return self.graph.device

    def _walk(self, glob: dict, host: list, device: torch.device) -> dict:
        """Run the nodes in order over ``glob``, writing its tensors in
        place; returns ``glob`` (with any buffer the graph creates)."""
        hi = 0
        for node in self.graph.nodes:
            if node.kind == "kernel":
                entry = get_backend(node.backend)
                with lower_cuda.in_place():
                    out = entry.run(node.kernel, grid=node.grid,
                                    block=node.block, glob=dict(glob),
                                    grain=node.grain,
                                    dyn_shared=node.dyn_shared,
                                    interpret=node.interpret,
                                    **api.device_opts(entry, node.devices,
                                                      node.shard_axis))
                write_back(glob, {b: out[b] for b in node.writes})
            elif node.kind == "h2d":
                src = host[hi]
                hi += 1
                if node.buffer not in glob:
                    glob[node.buffer] = torch.empty_like(src, device=device)
                write_back(glob, {node.buffer: src})
            elif node.kind == "d2d":
                if node.buffer not in glob:
                    glob[node.buffer] = torch.empty_like(glob[node.src])
                if node.buffer != node.src:
                    glob[node.buffer].copy_(glob[node.src])
            elif node.kind == "update":
                upd = node.fn(dict(glob))
                write_back(glob, {b: upd[b] for b in node.writes})
            # event nodes: ordering only, nothing to execute
        return glob

    def _capture(self, heap: dict, device: torch.device) -> None:
        """Record the nodes into one CUDA graph over ``heap``'s tensors."""
        stream = torch.cuda.Stream(device)
        self._staged = [h.pin_memory() if h.device.type == "cpu" else h
                        for h in self._host]
        with torch.cuda.stream(stream):
            for node in self.graph.nodes:
                if node.kind == "kernel" and node.backend == "cuda":
                    lower_cuda.prepare_capture(node.kernel, heap,
                                               node.dyn_shared)
        kernels = list(lower_cuda.KERNELS.values())
        before = [k.launches for k in kernels]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                glob = self._walk(dict(heap), self._staged, device)
        finally:
            counts = [(k, k.launches - n) for k, n in zip(kernels, before)]
            for k, n in zip(kernels, before):
                k.launches = n
        self._counts = [(k, n) for k, n in counts if n]
        self._cuda_graph = graph
        self._static = glob

    def _bind(self, heap: dict) -> None:
        """Copy into the captured tensors any heap value held elsewhere."""
        for b, t in heap.items():
            static = self._static[b]
            if t is static:
                continue
            if (t.shape, t.dtype, t.device) != (static.shape, static.dtype,
                                                static.device):
                raise GraphError(
                    f"graph replay: heap buffer {b!r} is ({tuple(t.shape)}, "
                    f"{t.dtype}, {t.device}); the graph was captured over "
                    f"({tuple(static.shape)}, {static.dtype}, "
                    f"{static.device}) - re-capture instead")
            static.copy_(t)

    def validate(self, buffers: dict) -> None:
        """Check the heap has every input; on the card, capture over it."""
        heap = self._heap(buffers)
        device = self._device(heap)
        if device.type == "cuda" and self._cuda_graph is None:
            self._capture(heap, device)

    def update_h2d(self, buffer: str, host) -> None:
        """Swap a captured memcpy's source (cudaGraphExecMemcpyNodeSetParams
        analogue): same shape/dtype, no re-instantiation needed."""
        h2d_nodes = [n for n in self.graph.nodes if n.kind == "h2d"]
        matches = [i for i, n in enumerate(h2d_nodes) if n.buffer == buffer]
        if not matches:
            raise GraphError(
                f"no captured h2d node writes buffer {buffer!r}")
        if len(matches) > 1:
            raise GraphError(
                f"{len(matches)} captured h2d nodes write buffer "
                f"{buffer!r}; per-node updates of multi-copy graphs are "
                f"not supported - re-capture instead")
        i = matches[0]
        old = self._host[i]
        new = host if isinstance(host, torch.Tensor) \
            else memory_mod.host_tensor(host)
        if old.shape != new.shape or old.dtype != new.dtype:
            raise GraphError(
                f"update_h2d({buffer!r}): replacement must match the "
                f"captured copy ({tuple(old.shape)}, {old.dtype}), got "
                f"({tuple(new.shape)}, {new.dtype})")
        self._host[i] = new
        if self._cuda_graph is not None:
            if self._done is not None:     # a replay may still read it
                self._done.synchronize()
            self._staged[i].copy_(new)

    def replay(self, buffers: dict) -> dict:
        """Run the whole DAG over the heap; returns the written buffers."""
        heap = self._heap(buffers)
        device = self._device(heap)
        self.launches += 1
        if device.type != "cuda":
            glob = self._walk(heap, self._host, device)
            return {b: glob[b] for b in self.written}
        if self._cuda_graph is None:
            self._capture(heap, device)
        self._bind(heap)
        self._cuda_graph.replay()
        self._done = torch.cuda.Event()
        self._done.record()
        for k, n in self._counts:
            k.launches += n
        return {b: self._static[b] for b in self.written}

    def launch(self, target) -> Any:
        """``cudaGraphLaunch``: replay onto a stream's (or runtime's
        default-stream's) heap, honoring cross-stream hazards."""
        stream = target.default if hasattr(target, "default") else target
        if getattr(stream, "_capture", None) is not None:
            raise GraphError(
                f"stream {stream.name!r} is capturing; graph launch inside "
                f"a capture is not supported")
        touched = self.graph.touched()
        stream._wait_foreign_writers(touched)
        with stream._issue(touched):
            out = self.replay(stream.buffers)
        stream.buffers.update(out)
        stream._wrote(self.written)
        stream._mark_pending(self.written)
        stream.stats.graph_launches += 1
        return stream
