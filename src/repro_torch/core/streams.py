"""Stream runtime: async launches, events, implicit barriers (paper SIII-C.1).

CuPBoP keeps kernel launches asynchronous (the host thread pushes a task and
continues) and inserts a barrier *only* when a later host operation reads or
writes a buffer a pending kernel writes (Listing 4).  HIP-CPU, by contrast,
synchronizes before every memcpy - the paper measures this as a 30 % average
slowdown (SV-B.2, FIR).

The bookkeeping is the reference's: each stream tracks its *pending
writers per buffer*, and

* ``Policy.HAZARD_ONLY``  - CuPBoP: sync iff a RAW/WAW hazard exists;
* ``Policy.SYNC_ALWAYS``  - HIP-CPU baseline: sync after every launch.

``Stream.stats`` counts launches, syncs, inserted barriers and graph
launches (the Fig. 11 quantities); the same program counts the same here
as in the reference.

On the card the objects are CUDA's own.  A :class:`Stream` issues its work
on a ``torch.cuda.Stream`` (a standalone stream, and a runtime's stream
named ``"default"``, on the stream current when it was made; a runtime's
other streams on new ones); a launch writes the heap's tensors in place,
as a CUDA kernel does; an :class:`Event` is a ``torch.cuda.Event``.  Work
on one of a runtime's streams that touches a buffer another of its streams
touched last waits on that stream's event first (``cudaStreamWaitEvent``),
whatever the bookkeeping says; a barrier for a hazard on the stream's own
buffers, and ``synchronize``, block the host until the stream is done.  On
the CPU every operation completes when it is issued, and an event takes a
host clock stamp.

A :class:`Runtime` hosts *multiple named streams over one buffer heap*::

    rt = Runtime({"x": x, "y": y, "tmp": t})
    s0, s1 = rt.stream("compute"), rt.stream("copy")
    producer[grid, block, None, s0]()           # <<<g, b, 0, s0>>>
    ev = rt.event("produced")
    ev.record(s0)                               # cudaEventRecord
    s1.wait_event(ev)                           # cudaStreamWaitEvent
    consumer[grid, block, None, s1]()
    rt.synchronize()                            # cudaDeviceSynchronize

Streams also capture into graphs (:mod:`repro_torch.core.graphs`)::

    g = s.begin_capture()                       # cudaStreamBeginCapture
    kernel[grid, block, None, s]()              # recorded, not executed
    s.end_capture()                             # cudaStreamEndCapture
    ex = g.instantiate(s.buffers)               # cudaGraphInstantiate
    ex.launch(s)                                # cudaGraphLaunch

While capturing, launches, ``memcpy_h2d``/``memcpy_d2d``, heap updates and
event record/wait become DAG nodes; host-visible operations
(``memcpy_d2h``, ``synchronize``, ``malloc``) raise ``GraphError`` - the
cudaErrorStreamCaptureUnsupported rule.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import api, lower_cuda
from repro_torch.core import graphs as graphs_mod
from repro_torch.core import memory as memory_mod
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import KernelDef
from repro_torch.core.lower_shard import DEFAULT_AXIS


class Policy(enum.Enum):
    HAZARD_ONLY = "hazard_only"    # CuPBoP
    SYNC_ALWAYS = "sync_always"    # HIP-CPU baseline


@dataclasses.dataclass
class StreamStats:
    launches: int = 0
    syncs: int = 0
    barriers_inserted: int = 0
    graph_launches: int = 0

    def __iadd__(self, other: "StreamStats") -> "StreamStats":
        self.launches += other.launches
        self.syncs += other.syncs
        self.barriers_inserted += other.barriers_inserted
        self.graph_launches += other.graph_launches
        return self


def heap_device(buffers: dict, device=None) -> torch.device:
    """The device a heap's tensors lie on (they must share one, of the
    type of ``device`` when it is given); an empty heap takes
    :func:`~repro_torch.core.memory.resolve_device` of ``device``."""
    tensors = [memory_mod.unwrap(v) for v in buffers.values()]
    bad = [type(t).__name__ for t in tensors
           if not isinstance(t, torch.Tensor)]
    if bad:
        raise TypeError(f"heap buffers must be torch tensors, DeviceBuffer "
                        f"or ConstArray handles; got {sorted(set(bad))} "
                        f"(carry.from_reference converts NumPy)")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"heap buffers lie on several devices: "
                         f"{sorted(str(d) for d in devices)}")
    if not devices:
        return memory_mod.resolve_device(device)
    dev = devices.pop()
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"heap buffers lie on {dev}, not on {device}")
    return dev


class Event:
    """A CUDA event: a fence over the work a stream had issued at record.

    ``record`` notes which of the stream's pending buffers it fences (and
    at which write of each, so a later write is not mistaken for the
    fenced one) and records a ``torch.cuda.Event(enable_timing=True)`` on
    the card, or takes a host clock stamp on the CPU, where the work is
    done when it is issued.  ``elapsed`` is ``cudaEventElapsedTime``, in
    milliseconds.
    """

    def __init__(self, name: str = "event"):
        self.name = name
        self._fence: dict[str, int] = {}   # buffer -> write count at record
        self._stream: "Stream | None" = None
        self._recorded = False
        self._cuda: torch.cuda.Event | None = None
        self._stamp: float | None = None
        self._capture = None       # (Graph, node idx) when captured

    def record(self, stream: "Stream") -> "Event":
        """Fence ``stream``'s work so far (cudaEventRecord)."""
        if stream._capture is not None:
            stream._capture.add_event_record(stream, self)
            return self
        self._capture = None       # eager re-record supersedes a capture
        self._fence = {n: stream._versions.get(n, 0) for n in stream._pending}
        self._stream = stream
        self._recorded = True
        if stream.cuda_stream is not None:
            self._cuda = torch.cuda.Event(enable_timing=True)
            self._cuda.record(stream.cuda_stream)
        else:
            self._cuda, self._stamp = None, time.perf_counter()
        return self

    def query(self) -> bool:
        """True iff all fenced work has finished (cudaEventQuery)."""
        if not self._recorded:
            return False
        return self._cuda is None or self._cuda.query()

    def synchronize(self) -> "Event":
        """Block until the fenced work completes (cudaEventSynchronize)."""
        if not self._recorded:
            raise RuntimeError(f"event {self.name!r} was never recorded")
        if self._cuda is not None:
            self._cuda.synchronize()
        return self

    def elapsed(self, later: "Event") -> float:
        """Milliseconds between this event and ``later``
        (cudaEventElapsedTime; both must have been recorded eagerly).

        Raises ``RuntimeError`` - never returns garbage or ``None`` - when
        either record point is missing: an event that was never recorded
        (cudaErrorInvalidResourceHandle), or one captured into a graph
        (its record runs only at replay, which stamps nothing), or when
        the two were recorded on different devices.
        """
        for role, e in (("start", self), ("end", later)):
            if e._capture is not None:
                raise RuntimeError(
                    f"cannot compute elapsed time: {role} event {e.name!r} "
                    f"was captured into a graph, not recorded eagerly")
            if not e._recorded:
                raise RuntimeError(
                    f"cannot compute elapsed time: {role} event {e.name!r} "
                    f"has not been recorded (cudaEventRecord first)")
        self.synchronize()
        later.synchronize()
        if (self._cuda is None) != (later._cuda is None):
            raise RuntimeError(
                f"cannot compute elapsed time: events {self.name!r} and "
                f"{later.name!r} were recorded on different devices")
        if self._cuda is not None:
            return self._cuda.elapsed_time(later._cuda)
        return (later._stamp - self._stamp) * 1e3


class Stream:
    """A CUDA stream over named global buffers.

    Standalone it owns a private heap; created through a :class:`Runtime`
    it shares the runtime's heap and takes part in cross-stream hazard
    tracking.  Its device is the one its heap's tensors lie on
    (:func:`heap_device`; ``device`` decides for an empty heap).
    """

    def __init__(self, buffers: dict[str, Any] | None = None,
                 policy: Policy = Policy.HAZARD_ONLY,
                 *, name: str = "stream0",
                 runtime: "Runtime | None" = None, device=None):
        self.name = name
        self.runtime = runtime
        if runtime is not None:
            self.buffers = runtime.buffers      # shared heap (same object)
            if buffers:
                self.buffers.update(buffers)
            self.device = runtime.device
        else:
            self.buffers = dict(buffers or {})
            self.device = heap_device(self.buffers, device)
        self.policy = policy
        self._pending: set[str] = set()   # buffers with an in-flight writer
        self._versions: dict[str, int] = {}   # writes issued per buffer
        self._capture: "graphs_mod.Graph | None" = None
        self.stats = StreamStats()
        self.cuda_stream: torch.cuda.Stream | None = None
        if self.device.type == "cuda":
            self.cuda_stream = (
                torch.cuda.Stream(self.device)
                if runtime is not None and name != "default"
                else torch.cuda.current_stream(self.device))

    # -- graph capture (cudaStreamBeginCapture / cudaStreamEndCapture) -------
    def begin_capture(self, graph: "graphs_mod.Graph | None" = None):
        """Start recording this stream's work into a graph.

        Subsequent launches, ``memcpy_h2d``/``memcpy_d2d``, heap updates
        and event record/wait calls become DAG nodes instead of running.
        Pass an existing ``graph`` to capture several streams into one DAG
        (or use ``Runtime.begin_capture``).
        """
        if self._capture is not None:
            raise graphs_mod.GraphError(
                f"stream {self.name!r} is already capturing")
        g = graph if graph is not None else graphs_mod.Graph()
        g._attach(self)
        self._capture = g
        return g

    def end_capture(self) -> "graphs_mod.Graph":
        """Stop capturing and return the graph (cudaStreamEndCapture)."""
        if self._capture is None:
            raise graphs_mod.GraphError(
                f"stream {self.name!r} is not capturing")
        g = self._capture
        self._capture = None
        g._detach(self)
        return g

    def _forbid_capture(self, op: str):
        if self._capture is not None:
            raise graphs_mod.GraphError(
                f"{op} on capturing stream {self.name!r}: host-visible "
                f"operations are not capturable "
                f"(cudaErrorStreamCaptureUnsupported)")

    # -- memory management (Fig. 3 library replacement) ----------------------
    def malloc(self, name: str, shape, dtype):
        self._forbid_capture("malloc")
        with self._issue({name}):
            self.buffers[name] = torch.zeros(
                shape, dtype=memory_mod.torch_dtype(dtype),
                device=self.device)
        self._wrote((name,))
        return name

    def _forbid_const_dst(self, op: str, name: str):
        if isinstance(self.buffers.get(name), memory_mod.ConstArray):
            raise memory_mod.UnsupportedSpace(
                f"{op} into heap buffer {name!r}: it is __constant__ "
                f"(ConstArray); constant memory is read-only on device")

    def _store(self, name: str, value: torch.Tensor, touched=()) -> None:
        """Copy ``value`` into heap buffer ``name`` on this stream: into
        its tensor when the geometry matches, else into a new one."""
        with self._issue({name, *touched}):
            cur = self.buffers.get(name)
            cur = None if cur is None else memory_mod.unwrap(cur, "write")
            if cur is None or (cur.shape, cur.dtype) != (value.shape,
                                                         value.dtype):
                cur = self.buffers[name] = torch.empty_like(
                    value, device=self.device)
            cur.copy_(value, non_blocking=True)
        self._wrote((name,))

    def memcpy_h2d(self, name: str, host: np.ndarray):
        self._forbid_const_dst("memcpy_h2d", name)
        if self._capture is not None:
            self._capture.add_h2d(self, name, memory_mod.host_tensor(host))
            return
        # host->device write: must order after pending writers of `name`
        self._barrier_if_hazard({name})
        self._store(name, memory_mod.stage_h2d(host, self.device))

    def memcpy_d2d(self, dst: str, src):
        """cudaMemcpyDeviceToDevice onto the named heap (capturable).

        ``src`` is another heap name, or a tensor / tracked handle whose
        value lands on the heap.  Named-to-named copies capture as graph
        ``d2d`` nodes; tensor-source copies capture like an h2d node with
        a device-resident payload (its value at capture).  An existing
        destination must match the source's geometry (CUDA's byte-count
        rule).
        """
        self._forbid_const_dst("memcpy_d2d", dst)

        def check_against_heap(val):
            # CUDA's byte-count rule, enforced at enqueue time on both the
            # eager and capture paths
            have = self.buffers.get(dst)
            if have is not None:
                cur = memory_mod.unwrap(have, "memcpy_d2d")
                memory_mod._check_geometry("d2d", cur.shape, cur.dtype,
                                           val.shape, val.dtype)

        if isinstance(src, str):
            if self._capture is not None:
                if src in self.buffers:
                    check_against_heap(
                        memory_mod.unwrap(self.buffers[src], "memcpy_d2d"))
                self._capture.add_d2d(self, dst, src)  # validates the source
                return
            if src not in self.buffers:
                raise KeyError(
                    f"stream {self.name!r}: no source buffer {src!r} on the "
                    f"heap; malloc/memcpy_h2d first (typo'd name?)")
            self._barrier_if_hazard({dst, src})
            val = memory_mod.unwrap(self.buffers[src], "memcpy_d2d")
            touched = (src,)
        else:
            val = memory_mod.unwrap(src, "memcpy_d2d")
            if self._capture is not None:
                check_against_heap(val)
                self._capture.add_h2d(self, dst, val.clone())
                return
            self._barrier_if_hazard({dst})
            touched = ()
        check_against_heap(val)
        cur = self.buffers.get(dst)
        if cur is None or val is not memory_mod.unwrap(cur):
            self._store(dst, val, touched)
        self._mark_pending((dst,))

    def memcpy_d2h(self, name: str) -> np.ndarray:
        self._forbid_capture("memcpy_d2h")
        self._barrier_if_hazard({name})
        with self._issue({name}):
            return memory_mod.host_array(
                memory_mod.unwrap(self.buffers[name], "memcpy_d2h"))

    def device_update(self, fn, writes: tuple | None = None) -> tuple:
        """Apply an on-device heap update: ``fn(buffers) -> overrides``.

        The device-resident analogue of host code between chained CUDA
        launches: ``fn`` must be a pure function of the heap (torch ops on
        its tensors, no host read).  Eagerly it runs on the stream, with
        no host sync, and writes the overrides into the heap's tensors in
        place - every override computed before any is written, so a
        ping-pong ``{"src": bufs["dst"], "dst": zeros}`` cannot clobber
        itself (:func:`~repro_torch.core.graphs.write_back`).  During
        capture it becomes a graph *update node*.  ``writes`` names the
        updated buffers; when omitted they are inferred by running ``fn``
        once on the heap.  Returns the written names.
        """
        raw = {n: memory_mod.unwrap(v, "device_update")
               for n, v in self.buffers.items()}
        if self._capture is not None:
            if writes is None:
                with self._issue(set(raw)):
                    writes = tuple(sorted(fn(raw)))
            for name in writes:
                self._forbid_const_dst("device_update", name)
            self._capture.add_update(self, fn, writes)
            return writes
        self._wait_foreign_writers(set(self.buffers))
        with self._issue(set(raw)):
            upd = fn(raw)
            if writes is None:
                writes = tuple(sorted(upd))
            for name in writes:
                self._forbid_const_dst("device_update", name)
            graphs_mod.write_back(self.buffers, {n: upd[n] for n in writes})
        self._wrote(writes)
        self._mark_pending(writes)
        return writes

    # -- kernel launch (async; Fig. 5) ---------------------------------------
    def launch(self, kernel: KernelDef, *, grid, block,
               backend: str = "vector", grain: int | str = 1,
               dyn_shared: int | None = None,
               args: dict[str, Any] | None = None,
               interpret: bool = True, pool: int | None = None,
               devices: int | None = None,
               shard_axis: str = DEFAULT_AXIS, optimize=None):
        """Async launch over the stream's heap.

        The kernel sees the full heap (device memory) and writes its
        buffers there in place; a non-None value in ``args`` is copied
        onto the heap first (an implicit ``memcpy_h2d``, with the usual
        hazard ordering), so ``kernel[g, b, None, s](a=x)`` computes on
        ``x`` and the heap's other buffers.

        ``args`` values may be tracked :class:`~repro_torch.core.memory
        .DeviceBuffer` handles: they are liveness-checked and their values
        land on the heap, and handles bound to buffers the kernel declares
        in ``donates`` are re-bound to the heap's tensor after the launch
        (the CUDA in-place view).

        ``optimize=True`` (or ``CUPBOP_OPTIMIZE=1``) launches the
        barrier-fission optimizer's derived kernel; under capture the
        graph node stores it (:meth:`Graph.add_kernel`).  ``devices``/
        ``shard_axis`` reach a multi-device backend (``shard``), under
        capture through the graph node.
        """
        grid, block = Dim3.of(grid), Dim3.of(block)
        handles = {n: v for n, v in (args or {}).items()
                   if isinstance(v, memory_mod.DeviceBuffer)}
        if args:
            args = {n: (memory_mod.unwrap(v, "launch") if n in handles
                        else v)
                    for n, v in args.items()}
        if self._capture is not None:
            known = set(self.buffers) | self._capture.written()
            missing = [n for n in (args or {}) if n not in known]
            if missing:
                raise KeyError(
                    f"stream {self.name!r}: no buffer(s) {missing} on the "
                    f"heap; malloc/memcpy_h2d first (typo'd name?)")
            for n, v in (args or {}).items():
                if v is not None:       # arg update = captured h2d node
                    self._capture.add_h2d(
                        self, n, memory_mod.unwrap(v, "launch").clone())
            self._capture.add_kernel(
                self, kernel, grid=grid, block=block, backend=backend,
                grain=grain, dyn_shared=dyn_shared, interpret=interpret,
                pool=pool, devices=devices, shard_axis=shard_axis,
                optimize=optimize)
            return
        if args:
            missing = [n for n in args if n not in self.buffers]
            if missing:
                raise KeyError(
                    f"stream {self.name!r}: no buffer(s) {missing} on the "
                    f"heap; malloc/memcpy_h2d first (typo'd name?)")
            updates = {n: v for n, v in args.items() if v is not None}
            if updates:
                self._barrier_if_hazard(set(updates))
                for n, v in updates.items():
                    self._store(n, v)
        buf_args = dict(self.buffers)
        # order after in-flight writers of touched buffers on OTHER streams
        self._wait_foreign_writers(set(buf_args) | set(kernel.writes))
        touched = set(buf_args) if kernel.reads is None \
            else {*kernel.reads, *kernel.writes}
        with self._issue(touched), lower_cuda.in_place():
            new = api.launch(kernel, grid=grid, block=block, args=buf_args,
                             backend=backend, grain=grain,
                             dyn_shared=dyn_shared, interpret=interpret,
                             pool=pool, devices=devices,
                             shard_axis=shard_axis, optimize=optimize)
            graphs_mod.write_back(self.buffers,
                                  {n: new[n] for n in kernel.writes})
        memory_mod.rebind_outputs(kernel, handles,
                                  {n: self.buffers[n] for n in kernel.writes
                                   if n in handles})
        self._wrote(kernel.writes)
        self._mark_pending(kernel.writes)
        self.stats.launches += 1
        if self.policy is Policy.SYNC_ALWAYS:
            self.synchronize()

    # -- events ---------------------------------------------------------------
    def record(self, event: Event | None = None) -> Event:
        """Record ``event`` on this stream (cudaEventRecord); creates one
        when called bare."""
        return (event or Event()).record(self)

    def wait_event(self, event: Event):
        """cudaStreamWaitEvent: order this stream after ``event``.

        On the card the stream waits on the event's ``torch.cuda.Event``:
        a device-side edge, no host stall.  The bookkeeping counts a
        barrier when fenced work is still pending on the recording stream
        at the write the event fenced - work launched there after the
        record is not waited on (and stays pending there).

        During capture the wait becomes a DAG edge from the event's record
        node (which must belong to the same graph).
        """
        if self._capture is not None:
            self._capture.add_event_wait(self, event)
            return
        if event._capture is not None:
            raise graphs_mod.GraphError(
                f"stream {self.name!r} cannot eagerly wait on event "
                f"{event.name!r}: it was captured into a graph and only "
                f"fires at replay")
        if not event._recorded:
            raise RuntimeError(
                f"stream {self.name!r} cannot wait on unrecorded event "
                f"{event.name!r}")
        src = event._stream
        if src is None or src is self:
            return  # same-stream wait: program order already serializes
        if self.cuda_stream is not None and event._cuda is not None:
            self.cuda_stream.wait_event(event._cuda)
        # pending buffers whose in-flight write IS the fenced one
        fenced = {n for n, v in event._fence.items()
                  if n in src._pending and src._versions.get(n, 0) == v}
        if fenced:
            self.stats.barriers_inserted += 1
            src._sync_buffers(fenced, block=False)

    # -- synchronization ------------------------------------------------------
    @contextlib.contextmanager
    def _issue(self, touched: set[str]):
        """Issue device work on this stream that touches ``touched``.

        On the card, with a runtime, the stream first waits on the event
        of whichever other stream touched each buffer last, and afterwards
        records its own - whether or not the bookkeeping holds the buffer
        pending - since launches write in place."""
        access = None
        if self.cuda_stream is not None and self.runtime is not None:
            access = self.runtime._access
            waited = set()
            for n in touched:
                owner, ev = access.get(n, (None, None))
                if owner is not None and owner is not self and \
                        id(ev) not in waited:
                    waited.add(id(ev))
                    self.cuda_stream.wait_event(ev)
        with memory_mod._on_stream(self):
            yield
        if access is not None:
            ev = torch.cuda.Event()
            ev.record(self.cuda_stream)
            for n in touched:
                access[n] = (self, ev)

    def _wrote(self, names):
        for n in names:
            self._versions[n] = self._versions.get(n, 0) + 1

    def _mark_pending(self, names):
        self._pending.update(names)
        if self.runtime is not None:
            for n in names:
                self.runtime._writers[n] = self

    def _wait_foreign_writers(self, touched: set[str]):
        """Cross-stream implicit barrier (Listing 4, stream-to-stream).

        Bookkeeping only: on the card :meth:`_issue` orders the work."""
        if self.runtime is None:
            return
        by_owner: dict[Stream, set[str]] = {}
        for n in touched:
            owner = self.runtime._writers.get(n)
            if owner is not None and owner is not self and n in owner._pending:
                by_owner.setdefault(owner, set()).add(n)
        for owner, names in by_owner.items():
            self.stats.barriers_inserted += 1
            owner._sync_buffers(names, block=False)

    def _barrier_if_hazard(self, touched: set[str]):
        self._wait_foreign_writers(touched)
        if self.policy is Policy.SYNC_ALWAYS:
            self.synchronize()
            return
        hazard = touched & self._pending
        if hazard:
            self.stats.barriers_inserted += 1
            self._sync_buffers(hazard)

    def _sync_buffers(self, names, block: bool = True):
        """Retire ``names``' pending writes (one sync); ``block`` waits on
        the card for the stream's work to finish."""
        if block and self.cuda_stream is not None:
            self.cuda_stream.synchronize()
        self._pending -= set(names)
        if self.runtime is not None:
            for n in names:
                if self.runtime._writers.get(n) is self:
                    del self.runtime._writers[n]
        self.stats.syncs += 1

    def synchronize(self):
        """cudaStreamSynchronize.  Counts a sync only when something is
        pending (the reference's Fig. 11 accounting); on the card it always
        waits for the stream's work."""
        self._forbid_capture("synchronize")
        if self.cuda_stream is not None:
            self.cuda_stream.synchronize()
        if not self._pending:
            return
        self._sync_buffers(set(self._pending), block=False)


class Runtime:
    """A device context: one buffer heap, many named streams, events.

    The CUDA-shaped entry point for multi-stream programs; single-stream
    code can keep using a bare :class:`Stream`.
    """

    def __init__(self, buffers: dict[str, Any] | None = None,
                 policy: Policy = Policy.HAZARD_ONLY, *, device=None):
        self.policy = policy
        self.buffers: dict[str, Any] = dict(buffers or {})
        self.device = heap_device(self.buffers, device)
        self._writers: dict[str, Stream] = {}   # buffer -> in-flight writer
        #: buffer -> (stream, torch.cuda.Event) of its last access (card)
        self._access: dict[str, tuple] = {}
        self._streams: dict[str, Stream] = {}
        self._event_ids = itertools.count()
        self._capture: "graphs_mod.Graph | None" = None

    # -- streams --------------------------------------------------------------
    def stream(self, name: str = "default") -> Stream:
        """Get-or-create the named stream (cudaStreamCreate).

        A stream created during ``begin_capture`` joins the capture.
        """
        if name not in self._streams:
            s = Stream(policy=self.policy, name=name, runtime=self)
            if self._capture is not None:
                s.begin_capture(self._capture)
            self._streams[name] = s
        return self._streams[name]

    # -- graph capture (device-wide: every stream records into one DAG) ------
    def begin_capture(self) -> "graphs_mod.Graph":
        """Capture all of this runtime's streams into one graph."""
        if self._capture is not None:
            raise graphs_mod.GraphError("runtime is already capturing")
        busy = [s.name for s in self._streams.values()
                if s._capture is not None]
        if busy:    # check first: a partial attach would half-capture
            raise graphs_mod.GraphError(
                f"runtime cannot begin capture: stream(s) {busy} are "
                f"already capturing independently")
        g = graphs_mod.Graph()
        for s in self._streams.values():
            s.begin_capture(g)
        self._capture = g
        return g

    def end_capture(self) -> "graphs_mod.Graph":
        """End the device-wide capture and return the graph."""
        if self._capture is None:
            raise graphs_mod.GraphError("runtime is not capturing")
        g = self._capture
        self._capture = None
        for s in self._streams.values():
            if s._capture is g:
                s.end_capture()
        return g

    @property
    def streams(self) -> tuple[Stream, ...]:
        return tuple(self._streams.values())

    @property
    def default(self) -> Stream:
        return self.stream("default")

    # -- events ---------------------------------------------------------------
    def event(self, name: str | None = None) -> Event:
        """cudaEventCreate."""
        return Event(name or f"event{next(self._event_ids)}")

    # -- memory (default-stream semantics, as in CUDA's NULL stream) ----------
    def malloc(self, name: str, shape, dtype):
        return self.default.malloc(name, shape, dtype)

    def memcpy_h2d(self, name: str, host: np.ndarray):
        self.default.memcpy_h2d(name, host)

    def memcpy_d2d(self, dst: str, src):
        self.default.memcpy_d2d(dst, src)

    def memcpy_d2h(self, name: str) -> np.ndarray:
        return self.default.memcpy_d2h(name)

    def device_update(self, fn, writes: tuple | None = None) -> tuple:
        return self.default.device_update(fn, writes)

    # -- synchronization ------------------------------------------------------
    def synchronize(self):
        """cudaDeviceSynchronize: drain every stream."""
        for s in self._streams.values():
            s.synchronize()

    @property
    def stats(self) -> StreamStats:
        """Aggregate launch/sync/barrier counts across all streams."""
        total = StreamStats()
        for s in self._streams.values():
            total += s.stats
        return total
