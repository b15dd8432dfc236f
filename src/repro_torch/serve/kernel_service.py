"""Multi-tenant kernel-serving tier: one Runtime, warm caches, batched dispatch.

The host runtime of the paper exists so CUDA launch traffic can run
*sustained* (SIII-C: async launches, hazard-only syncs).  This module
spends that foundation on serving: a persistent worker that owns one
:class:`~repro_torch.core.streams.Runtime` on one device plus the shared
compile cache, and admits concurrent kernel-launch requests from many
tenants.  The request lifecycle is

    admission -> batching -> dispatch -> emit

* **admission** - ``submit()`` validates the request against its
  registered endpoint (every non-resident buffer the kernel touches must
  be supplied, so one tenant can never compute on another's data), then
  enqueues onto a *bounded* queue: a full queue raises
  :class:`ServiceOverloaded` (backpressure), and requests that out-wait
  their per-request timeout fail with :class:`ServiceTimeout` instead of
  occupying a dispatch slot.
* **batching** - requests hitting the same specialization (kernel
  fingerprint x geometry x backend x optimize/sanitize flags x buffer
  shapes, dtypes and devices) within the admission window are stacked
  into ONE dispatch via :func:`repro_torch.core.api.launch_batch` and
  unstacked on completion.  Batches pad up to power-of-two buckets (rows
  replicate the last request, pad rows are discarded) so steady traffic
  reuses a handful of entries instead of building one per occupancy; on
  the card a ``cuda`` entry launches the bucket's rows back to back.
* **dispatch** - singletons route through the endpoint's *named stream*
  on the service Runtime (the paper's async-launch path, hazard-tracked);
  batches go through the batch entry on the worker's stream.  Both hit
  the same compiled-launch LRU, which is what makes a warm service cheap.
* **emit** - the only host sync: results wait for the stream that wrote
  them (the RAW hazard - host read of a device write: an event recorded
  after the dispatch, or the named stream's synchronize; a no-op on the
  CPU) before the ticket completes, so reported latency is honest
  device-done latency.

Requests hand in tensors on the service's device.  A dispatch never
writes them: a batch's launches are functional, and a single launch's
written buffers are copied onto the stream's heap before it runs in
place there.

Failure isolation: any per-request error (``SanitizerError``,
``OptimizeError``, ``CudaError``, ``UnsupportedSpace``, ...) is caught
and stored on that request's ticket; a failing *stacked* dispatch falls
back to independent dispatches so one poisoned tenant cannot take down
co-batched requests; the worker thread never dies with the service open.

Observability: :meth:`KernelService.stats` snapshots a
:class:`ServiceStats` - per-kernel p50/p99 latency, throughput, warm-hit
rate (compile-cache hit fraction since service start), batch-occupancy
histogram, and queue depth.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core import memory as memory_mod
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import KernelDef, LaunchChain, UnsupportedKernel
from repro_torch.core.streams import Policy, Runtime

__all__ = [
    "Endpoint", "KernelService", "ServeTicket", "ServiceClosed",
    "ServiceError", "ServiceOverloaded", "ServiceStats", "ServiceTimeout",
]

#: per-endpoint latency reservoir bound (oldest samples age out)
_RESERVOIR = 4096


class ServiceError(RuntimeError):
    """Base class for serving-tier failures (bad request, bad endpoint)."""


class ServiceOverloaded(ServiceError):
    """Backpressure: the bounded admission queue is full; retry later."""


class ServiceTimeout(ServiceError):
    """The request out-waited its budget (queued too long, or the caller's
    ``result(timeout=...)`` expired before completion)."""


class ServiceClosed(ServiceError):
    """The service is shut down; no further requests are admitted."""


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """A registered workload: kernel(s) + geometry + resident buffers.

    ``bound`` buffers stay resident service-side (``__constant__`` tables,
    endpoint-owned lookup data) and are merged under every request;
    ``required`` is what each request must supply - the full read/write
    set minus the bound names, so no request ever reads leftover state.
    ``chain`` endpoints replay a :class:`LaunchChain` per request (never
    batched - wavefront iteration counts are data-dependent).
    """

    name: str
    kernel: KernelDef
    grid: Dim3
    block: Dim3
    dyn_shared: int | None
    backend: str
    bound: dict
    required: frozenset
    chain: LaunchChain | None = None
    const: tuple = ()
    fingerprint: str = ""

    @property
    def writes(self) -> tuple:
        if self.chain is not None:
            names: dict = {}
            for step in self.chain.steps:
                names.update(dict.fromkeys(step.kernel.writes))
            return tuple(names)
        return tuple(self.kernel.writes)


class ServeTicket:
    """A submitted request's future: ``result()`` blocks until the worker
    completes or fails it."""

    __slots__ = ("rid", "endpoint", "tenant", "args", "timeout", "key",
                 "submitted_at", "finished_at", "batch_size",
                 "_event", "_result", "_error")

    def __init__(self, rid: int, endpoint: str, tenant: str, args: dict,
                 timeout: float, key: tuple):
        self.rid, self.endpoint, self.tenant = rid, endpoint, tenant
        self.args, self.timeout, self.key = args, timeout, key
        self.submitted_at = time.monotonic()
        self.finished_at: float | None = None
        self.batch_size = 0
        self._event = threading.Event()
        self._result: dict | None = None
        self._error: Exception | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> dict:
        """The written buffers, or raise the request's failure."""
        if not self._event.wait(timeout):
            raise ServiceTimeout(
                f"request {self.rid} ({self.endpoint}): no result within "
                f"{timeout}s (still queued or in flight)")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    @property
    def latency_ms(self) -> float | None:
        """Submit-to-emit milliseconds (None while in flight)."""
        if self.finished_at is None:
            return None
        return (self.finished_at - self.submitted_at) * 1e3


@dataclasses.dataclass
class ServiceStats:
    """One observability snapshot.

    ``warm_hit_rate`` is the compiled-launch cache hit fraction across
    every dispatch since the service started - per *dispatch*, not per
    request: a warm batch of 8 requests is one hit.  ``batch_occupancy``
    maps actual batch size -> number of dispatches at that size.
    """

    submitted: int
    completed: int
    failed: int
    timed_out: int
    rejected: int
    dispatches: int
    batched_requests: int
    queue_depth: int
    max_queue_depth: int
    uptime_s: float
    throughput_rps: float
    warm_hit_rate: float
    cache_hits: int
    cache_misses: int
    batch_occupancy: dict
    kernels: dict
    streams: dict

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["batch_occupancy"] = {str(k): v for k, v
                                  in sorted(self.batch_occupancy.items())}
        return doc


def _percentile(samples, q: float) -> float:
    return float(np.percentile(np.asarray(samples, np.float64), q))


def _bucket(n: int, cap: int) -> int:
    """Round a batch up to its power-of-two compile bucket (<= cap)."""
    m = 1
    while m < n:
        m *= 2
    return min(m, cap)


class KernelService:
    """The persistent serving worker (see module docstring).

    ``device`` is the device the service runs on, the card unless the
    caller asks for the CPU; requests hand in tensors there.
    ``autostart=False`` leaves the worker thread unstarted - tests queue a
    deterministic request mix, then :meth:`start` to process it.  The
    service is a context manager; :meth:`close` drains (or fails) pending
    work and stops the worker.
    """

    def __init__(self, *, backend: str = "loop",
                 policy: Policy = Policy.HAZARD_ONLY,
                 max_queue: int = 256, max_batch: int = 16,
                 admission_window_ms: float = 2.0,
                 default_timeout_s: float = 60.0,
                 sanitize: bool | None = None,
                 optimize: bool | None = None,
                 autostart: bool = True, device=None):
        if max_queue < 1 or max_batch < 1:
            raise ValueError("max_queue and max_batch must be >= 1")
        self.backend = backend
        self.device = memory_mod.resolve_device(device)
        self.runtime = Runtime(policy=policy, device=self.device)
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.admission_window_s = float(admission_window_ms) / 1e3
        self.default_timeout_s = float(default_timeout_s)
        self.sanitize, self.optimize = sanitize, optimize
        self._endpoints: dict[str, Endpoint] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: collections.deque[ServeTicket] = collections.deque()
        self._closed = False
        self._rids = itertools.count()
        self._worker: threading.Thread | None = None
        self._started_at = time.monotonic()
        self._cache0 = api.cache_stats()
        self._unbatchable: set = set()
        # counters (all guarded by _lock)
        self._submitted = self._completed = self._failed = 0
        self._timed_out = self._rejected = 0
        self._dispatches = self._batched_requests = 0
        self._max_depth = 0
        self._occupancy: collections.Counter = collections.Counter()
        self._latency: dict[str, collections.deque] = {}
        if autostart:
            self.start()

    # -- endpoint registry ---------------------------------------------------
    def register(self, name: str, kernel: KernelDef, *, grid, block,
                 dyn_shared: int | None = None, backend: str | None = None,
                 bound: dict | None = None, const: tuple = (),
                 chain: LaunchChain | None = None) -> Endpoint:
        """Register a workload under ``name`` and create its named stream.

        ``bound`` buffers stay resident (merged under every request);
        everything else the kernel reads or writes becomes ``required``
        per request.  Names in ``const`` are wrapped ``__constant__``
        (:class:`~repro_torch.core.memory.ConstArray`) at dispatch.
        """
        if name in self._endpoints:
            raise ServiceError(f"endpoint {name!r} is already registered")
        bound = dict(bound or {})
        if chain is not None:
            kernels = [s.kernel for s in chain.steps]
        else:
            kernels = [kernel]
        touched: set = set()
        for k in kernels:
            touched |= set(k.writes) | set(k.reads or ())
        unknown = sorted(set(bound) - touched)
        if unknown:
            raise ServiceError(
                f"endpoint {name!r}: bound buffer(s) {unknown} are not in "
                f"the kernel's read/write set")
        ep = Endpoint(
            name=name, kernel=kernel, grid=Dim3.of(grid),
            block=Dim3.of(block), dyn_shared=dyn_shared,
            backend=backend or self.backend, bound=bound,
            required=frozenset(touched - set(bound)), chain=chain,
            const=tuple(const), fingerprint=kernel.fingerprint())
        self._endpoints[name] = ep
        self.runtime.stream(name)          # the endpoint's named stream
        return ep

    def register_entry(self, entry, *, backend: str | None = None,
                       name: str | None = None) -> Endpoint:
        """Register a :class:`~repro_torch.core.cuda_suite.SuiteEntry`
        (chain entries included; their ``const`` buffers are wrapped
        ``__constant__`` at dispatch, as ``run_entry`` does)."""
        return self.register(name or entry.name, entry.kernel,
                             grid=entry.grid, block=entry.block,
                             dyn_shared=entry.dyn_shared, backend=backend,
                             const=tuple(entry.const), chain=entry.chain)

    def endpoints(self) -> tuple:
        return tuple(self._endpoints)

    # -- admission -----------------------------------------------------------
    def _batch_key(self, ep: Endpoint, args: dict) -> tuple:
        def sig(v):
            u = memory_mod.unwrap(v, "submit")   # freed handles fail HERE
            return (tuple(u.shape), str(u.dtype),
                    str(getattr(u, "device", "host")))

        shapes = tuple(sorted((n, *sig(v)) for n, v in args.items()))
        return (ep.name, ep.fingerprint, ep.grid, ep.block, ep.dyn_shared,
                ep.backend, bool(self.optimize), bool(self.sanitize),
                ep.chain is not None, shapes)

    def submit(self, endpoint: str, args: dict, *, tenant: str = "anon",
               timeout: float | None = None) -> ServeTicket:
        """Admit one request; returns its :class:`ServeTicket` future.

        Raises :class:`ServiceError` on a malformed request (unknown
        endpoint, missing/unexpected buffers), :class:`ServiceOverloaded`
        when the queue is full, :class:`ServiceClosed` after shutdown.
        Execution errors surface from ``ticket.result()``, never here.
        """
        ep = self._endpoints.get(endpoint)
        if ep is None:
            raise ServiceError(
                f"unknown endpoint {endpoint!r}; registered: "
                f"{sorted(self._endpoints)}")
        missing = sorted(ep.required - set(args))
        if missing:
            raise ServiceError(
                f"request for {endpoint!r} is missing buffer(s) {missing} "
                f"(every non-resident buffer the kernel touches must be "
                f"supplied - requests never read another tenant's data)")
        extra = sorted(set(args) - ep.required)
        if extra:
            raise ServiceError(
                f"request for {endpoint!r} binds unknown buffer(s) {extra}; "
                f"expected exactly {sorted(ep.required)}")
        t = ServeTicket(next(self._rids), endpoint, tenant, dict(args),
                        self.default_timeout_s if timeout is None
                        else float(timeout),
                        self._batch_key(ep, args))
        with self._work:
            if self._closed:
                raise ServiceClosed("service is closed; no new requests")
            if len(self._queue) >= self.max_queue:
                self._rejected += 1
                raise ServiceOverloaded(
                    f"admission queue is full ({self.max_queue} pending); "
                    f"apply backpressure and retry")
            self._queue.append(t)
            self._submitted += 1
            self._max_depth = max(self._max_depth, len(self._queue))
            self._work.notify()
        return t

    # -- worker loop: admission window + compatible-batch draining ----------
    def start(self) -> "KernelService":
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name="kernel-service", daemon=True)
            self._worker.start()
        return self

    def _expired(self, t: ServeTicket, now: float) -> bool:
        if now - t.submitted_at <= t.timeout:
            return False
        self._timed_out += 1
        self._fail(t, ServiceTimeout(
            f"request {t.rid} ({t.endpoint}) timed out after "
            f"{t.timeout}s in the admission queue"), counted=True)
        return True

    def _take_compatible(self, key: tuple, room: int) -> list[ServeTicket]:
        """Pull queued requests sharing ``key`` (caller holds the lock)."""
        if room <= 0:
            return []
        now = time.monotonic()
        taken, kept = [], []
        while self._queue:
            t = self._queue.popleft()
            if self._expired(t, now):
                continue
            if t.key == key and len(taken) < room:
                taken.append(t)
            else:
                kept.append(t)
        self._queue.extend(kept)
        return taken

    def _run(self):
        # a new thread starts on device 0 with its default stream: enter
        # the service's device so every dispatch and emit happens there
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            self._serve()

    def _serve(self):
        while True:
            with self._work:
                while not self._queue and not self._closed:
                    self._work.wait()
                if not self._queue and self._closed:
                    return
                now = time.monotonic()
                head = self._queue.popleft()
                if self._expired(head, now):
                    continue
                batch = [head]
                batchable = (head.key not in self._unbatchable
                             and self._endpoints[head.endpoint].chain is None)
                if batchable:
                    deadline = now + self.admission_window_s
                    while len(batch) < self.max_batch:
                        batch += self._take_compatible(
                            head.key, self.max_batch - len(batch))
                        if len(batch) >= self.max_batch or self._closed:
                            break
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._work.wait(remaining)
            self._dispatch(batch)

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, batch: list[ServeTicket]):
        ep = self._endpoints[batch[0].endpoint]
        if len(batch) > 1:
            try:
                outs = self._run_batch(ep, batch)
            except UnsupportedKernel:
                # the backend genuinely cannot stack this specialization -
                # remember, so later traffic skips straight to singles
                with self._lock:
                    self._unbatchable.add(batch[0].key)
            except Exception:
                # a poisoned tenant (bad binding, sanitizer finding, ...)
                # failed the stacked dispatch as a unit: fall through to
                # independent dispatches so it only takes itself down
                pass
            else:
                self._record_dispatch(len(batch), batched=True)
                for t, out in zip(batch, outs):
                    self._complete(t, out, len(batch))
                return
        for t in batch:
            try:
                out = self._run_one(ep, t)
            except Exception as e:      # noqa: BLE001 - isolation boundary
                self._fail(t, e)
            else:
                self._complete(t, out, 1)
            self._record_dispatch(1, batched=False)

    def _merged(self, ep: Endpoint, t: ServeTicket) -> dict:
        merged = {**ep.bound, **t.args}
        for n in ep.const:
            v = merged[n]
            if not isinstance(v, memory_mod.ConstArray):
                merged[n] = memory_mod.ConstArray(v)
        return merged

    def _emit(self) -> None:
        """The RAW hazard sync of the worker's stream: an event recorded
        after the dispatch and waited on (nothing to wait for on the
        CPU)."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    def _run_batch(self, ep: Endpoint, batch: list[ServeTicket]) -> list:
        args_list = [self._merged(ep, t) for t in batch]
        n = len(args_list)
        pad = _bucket(n, self.max_batch) - n
        args_list += [args_list[-1]] * pad   # bucket pad; rows discarded
        outs = api.launch_batch(
            ep.kernel, grid=ep.grid, block=ep.block, args_list=args_list,
            backend=ep.backend, dyn_shared=ep.dyn_shared,
            sanitize=self.sanitize, optimize=self.optimize)[:n]
        results = [{k: memory_mod.unwrap(out[k], "emit") for k in ep.writes}
                   for out in outs]
        self._emit()                         # emit: the RAW hazard sync
        return results

    def _run_one(self, ep: Endpoint, t: ServeTicket) -> dict:
        merged = self._merged(ep, t)
        if ep.chain is not None:
            return self._run_chain(ep, merged)
        if self.sanitize:
            from repro_torch.core import analyze as analyze_mod
            analyze_mod.sanitize_launch(ep.kernel, grid=ep.grid,
                                        block=ep.block, args=merged,
                                        dyn_shared=ep.dyn_shared)
        # const-space and handle liveness, as a launch enforces them
        bufs = memory_mod.resolve_launch_args(ep.kernel, merged)
        stream = self.runtime.stream(ep.name)
        try:
            # the launch writes the heap in place: the written buffers go
            # there as copies, so the tenant's tensors stay as they were
            for n, v in bufs.items():
                stream.buffers[n] = v.clone() if n in ep.writes else v
            if stream.cuda_stream is not None:   # after the copies
                stream.cuda_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            stream.launch(ep.kernel, grid=ep.grid, block=ep.block,
                          backend=ep.backend, dyn_shared=ep.dyn_shared,
                          optimize=self.optimize)
            out = {n: stream.buffers[n] for n in ep.writes}
            stream.synchronize()             # emit: the RAW hazard sync
        finally:
            # requests supply every buffer, so nothing stays resident:
            # the next tenant (or endpoint reusing a name) starts clean
            stream.synchronize()
            for n in merged:
                stream.buffers.pop(n, None)
        # donated handles re-bind to their outputs, as a launch's do
        memory_mod.rebind_outputs(ep.kernel, merged, out)
        return out

    def _run_chain(self, ep: Endpoint, merged: dict) -> dict:
        def launch_step(step, bufs):
            return api.launch(step.kernel, grid=step.grid, block=step.block,
                              args=bufs, dyn_shared=step.dyn_shared,
                              backend=ep.backend, sanitize=self.sanitize,
                              optimize=self.optimize)
        assert ep.chain is not None
        out = ep.chain.run(launch_step, merged)
        result = {k: memory_mod.unwrap(out[k], "emit") for k in ep.writes}
        self._emit()
        return result

    # -- completion + accounting ---------------------------------------------
    def _record_dispatch(self, size: int, *, batched: bool):
        with self._lock:
            self._dispatches += 1
            self._occupancy[size] += 1
            if batched:
                self._batched_requests += size

    def _complete(self, t: ServeTicket, result: dict, batch_size: int):
        t.batch_size = batch_size
        t.finished_at = time.monotonic()
        with self._lock:
            self._completed += 1
            res = self._latency.setdefault(
                t.endpoint, collections.deque(maxlen=_RESERVOIR))
            res.append(t.finished_at - t.submitted_at)
        t._result = result
        t._event.set()

    def _fail(self, t: ServeTicket, err: Exception, *, counted: bool = False):
        t.finished_at = time.monotonic()
        if not counted:
            with self._lock:
                self._failed += 1
        t._error = err
        t._event.set()

    # -- observability -------------------------------------------------------
    def stats(self) -> ServiceStats:
        cache = api.cache_stats()
        hits = cache.hits - self._cache0.hits
        misses = cache.misses - self._cache0.misses
        uptime = time.monotonic() - self._started_at
        with self._lock:
            kernels = {}
            for name, res in self._latency.items():
                samples = [s * 1e3 for s in res]
                kernels[name] = {
                    "count": len(samples),
                    "p50_ms": round(_percentile(samples, 50), 4),
                    "p99_ms": round(_percentile(samples, 99), 4),
                    "mean_ms": round(float(np.mean(samples)), 4),
                }
            return ServiceStats(
                submitted=self._submitted, completed=self._completed,
                failed=self._failed, timed_out=self._timed_out,
                rejected=self._rejected, dispatches=self._dispatches,
                batched_requests=self._batched_requests,
                queue_depth=len(self._queue),
                max_queue_depth=self._max_depth,
                uptime_s=round(uptime, 4),
                throughput_rps=round(self._completed / max(uptime, 1e-9), 4),
                warm_hit_rate=round(hits / max(hits + misses, 1), 4),
                cache_hits=hits, cache_misses=misses,
                batch_occupancy=dict(self._occupancy),
                kernels=kernels,
                streams={
                    "launches": self.runtime.stats.launches,
                    "syncs": self.runtime.stats.syncs,
                    "barriers_inserted": self.runtime.stats.barriers_inserted,
                })

    # -- lifecycle -----------------------------------------------------------
    def close(self, *, drain: bool = True):
        """Stop admitting; drain pending work (or fail it) and join."""
        dropped: list[ServeTicket] = []
        with self._work:
            if self._closed and self._worker is None:
                return
            self._closed = True
            if not drain or self._worker is None:
                while self._queue:
                    dropped.append(self._queue.popleft())
            self._work.notify_all()
        # fail outside the condition: _fail takes the stats lock, which IS
        # the condition's lock (non-reentrant)
        for t in dropped:
            self._fail(t, ServiceClosed(
                f"request {t.rid} ({t.endpoint}) dropped: service "
                f"closed before dispatch"))
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def __enter__(self) -> "KernelService":
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))
