"""Token-level LM serving engine: continuous batching + stream semantics,
as ``repro/serve/engine.py``.

The token-granularity tier of the serving stack; the kernel-launch tier
is :mod:`repro_torch.serve.kernel_service`.  Both launch asynchronously
and block the host only on a true hazard.  Here:

* decode steps are launched without a host sync; greedy sampling
  (argmax) runs on the device, so the token fed to step t+1 is a device
  tensor the host never reads;
* the host blocks only when a finished step's tokens must be *emitted*
  (the RAW hazard: a host read of a device write);
* ``Policy.SYNC_ALWAYS`` reproduces HIP-CPU's sync-before-every-copy
  behaviour (``torch.cuda.synchronize`` after every step on the card).

Batching: fixed-slot continuous batcher - finished slots are refilled from
the queue, prefill runs per admission, decode advances all slots in one
eager step through ``models.transformer`` (on the card, its RMSNorm and
attention are the hand-written kernels).  An admitted request's one-row
cache is spliced into its slot leaf by leaf (``_splice``): keys and
values, and the state-space and RWKV mixers' recurrent states.  With experts, a decode step
routes every slot, idle ones included, so an idle slot's token takes
expert capacity as in the reference (ROADMAP, "Reference caveats").  The
cache is written in place; no step copies it whole.  ``stats`` counts
``launches`` (a prefill or a decode step), ``syncs`` and ``steps`` as the
reference does.

As the reference, the batch shares one ``pos``: a request admitted after
the others have advanced keeps zero keys between its prompt's end and
``pos``, attends to them, and its new tokens take RoPE positions from the
shared ``pos``.  The port reproduces this (ROADMAP, "Reference caveats").

Drive it with ``python -m repro_torch.launch.serve --lm``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory import resolve_device
from repro_torch.core.streams import Policy
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0


class Engine:
    """``params`` lie on ``device`` (the card unless ``"cpu"`` is asked
    for): on the card the model runs its kernels, on the CPU their plain
    versions."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, policy: Policy = Policy.HAZARD_ONLY,
                 device=None):
        self.device = resolve_device(device)
        if cfg.num_codebooks > 1:
            raise NotImplementedError(
                f"Engine: {cfg.name} takes {cfg.num_codebooks} codebook "
                f"tokens a position; the engine, as the reference's, keeps "
                f"one token a slot (drive prefill / decode_step directly)")
        on = params["final_norm"].device
        if on.type != self.device.type:
            raise ValueError(f"Engine: params lie on {on}, the engine "
                             f"serves on {self.device}")
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.policy = policy
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self.cache = T.init_cache(cfg, slots, max_len, device=self.device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long,
                                  device=self.device)
        self.lengths = np.zeros(slots, np.int64)
        self.stats = {"launches": 0, "syncs": 0, "steps": 0}

    def _greedy(self, logits):
        return logits[:, -1, : self.cfg.vocab_size].argmax(-1)[:, None]

    def _decode(self, toks):
        """One decode step of every slot: the next tokens, [slots, 1] on
        the device; the cache advances in place."""
        logits, self.cache = T.decode_step(self.cfg, self.params, self.cache,
                                           toks)
        return self._greedy(logits)

    def _prefill(self, prompt: np.ndarray):
        """One request's prompt: its first token, [1, 1] on the device, and
        its one-row cache."""
        lg, cache = T.prefill(self.cfg, self.params, {"tokens": prompt[None]},
                              max_len=self.max_len)
        return self._greedy(lg), cache

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        r = Request(len(self.queue), np.asarray(prompt, np.int32), max_new,
                    submitted_at=time.time())
        self.queue.append(r)
        return r

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                r = self.queue.pop(0)
                nxt, cache1 = self._prefill(r.prompt)
                self.stats["launches"] += 1
                self._splice(i, cache1)
                self.tokens[i] = nxt[0]
                self.lengths[i] = len(r.prompt)
                self.active[i] = r
                r.out.append(int(nxt[0, 0]))  # host read: sync point
                self.stats["syncs"] += 1

    def _splice(self, i: int, cache1: dict) -> None:
        """Write the one-row prefill cache into slot ``i`` in place, by the
        reference's rule: each leaf at its first axis whose size is
        ``slots`` in the engine's cache and 1 in the prefill's (a leaf
        with no such axis is left), the prefill's rows broadcast along
        the other axes; ``pos`` the larger of the two.  So a zamba2
        prompt of one token fills all three conv rows with its one row,
        and one of two tokens raises, as the reference's does."""
        for name, c in self.cache.items():
            if name == "pos":
                continue
            c1 = cache1[name]
            for ax in range(c.ndim):
                if c.shape[ax] == self.slots and c1.shape[ax] == 1:
                    c[(slice(None),) * ax + (slice(i, i + 1),)] = c1
                    break
        self.cache["pos"] = max(self.cache["pos"], cache1["pos"])

    def step(self):
        """One decode step for all active slots (async launch)."""
        self._admit()
        if not any(self.active):
            return False
        self.tokens = self._decode(self.tokens)
        self.stats["launches"] += 1
        self.stats["steps"] += 1
        if self.policy is Policy.SYNC_ALWAYS:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats["syncs"] += 1
        toks_host = None
        for i, r in enumerate(self.active):
            if r is None:
                continue
            if toks_host is None:
                # single hazard-driven sync for the emission batch
                toks_host = self.tokens.cpu().numpy()
                if self.policy is not Policy.SYNC_ALWAYS:
                    self.stats["syncs"] += 1
            r.out.append(int(toks_host[i, 0]))
            if len(r.out) >= r.max_new:
                r.done, r.finished_at = True, time.time()
                self.active[i] = None
        return True

    def run(self, max_steps: int = 1000):
        while (self.queue or any(self.active)) and max_steps > 0:
            if not self.step():
                break
            max_steps -= 1
