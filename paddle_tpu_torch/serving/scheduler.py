"""Continuous batching: admit/evict every step over bucketed decode shapes
(counterpart of ``paddle_tpu/serving/scheduler.py``, core loop).

The scheduler owns the request lifecycle (queued → running → finished)
and drives the engine one decode step at a time:

1. **evict** — sequences that hit ``max_new_tokens`` (or the optional
   EOS id) release their pages back to the pool;
2. **admit** — queued requests prefill (allocating pages) while a free
   batch slot exists AND the pool can hold the request's *full*
   completion (prompt + max_new, reserved up front, so a running
   sequence can never run the pool out of pages mid-decode);
3. **decode** — the active set, in admission order, runs one step of the
   smallest batch bucket that fits.

Not ported yet (ROADMAP.md, Queue 1, 'Serving: scheduler features'): SLO
tracking, overload modes and brownout, deadlines and cancel, live
migration, ``serve_http``, run logs and request telemetry.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Request", "ContinuousBatchingScheduler"]

_RETRY_AFTER_CAP_S = 30.0


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    eos_id: int | None = None
    submit_time: float = field(default_factory=time.perf_counter)
    admit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    prefill_s: float | None = None     # measured prefill walltime
    retry_after_s: float | None = None  # backpressure hint on rejects
    tokens: list = field(default_factory=list)   # generated ids
    token_times: list = field(default_factory=list)  # decode-step seconds
    state: str = "queued"              # queued|running|finished|rejected
    reject_reason: str | None = None   # max_new<1|too_long|retry_after|
    #                                    pool_too_small

    @property
    def output_ids(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    @property
    def done(self) -> bool:
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return bool(self.eos_id is not None and self.tokens
                    and self.tokens[-1] == self.eos_id)

    def summary(self) -> dict:
        """Per-request serving record (times in seconds; ``None`` where the
        phase has not happened)."""
        queue_wait = ttft = decode_s = total_s = tps = None
        if self.admit_time is not None:
            queue_wait = self.admit_time - self.submit_time
        if self.first_token_time is not None:
            ttft = self.first_token_time - self.submit_time
        if self.finish_time is not None:
            total_s = self.finish_time - self.submit_time
            if self.first_token_time is not None:
                decode_s = self.finish_time - self.first_token_time
        if decode_s is not None and decode_s > 0 and len(self.tokens) > 1:
            tps = (len(self.tokens) - 1) / decode_s
        out = {"rid": self.rid, "state": self.state,
               "reject_reason": self.reject_reason,
               "prompt_len": int(self.prompt.shape[0]),
               "new_tokens": len(self.tokens),
               "queue_wait_s": queue_wait, "ttft_s": ttft,
               "prefill_s": self.prefill_s,
               "decode_s": decode_s, "total_s": total_s,
               "decode_tokens_per_sec": tps}
        if self.retry_after_s is not None:
            out["retry_after_s"] = round(self.retry_after_s, 3)
        if self.token_times:
            st = sorted(self.token_times)
            out["per_token_s"] = {"n": len(st), "p50": st[len(st) // 2],
                                  "max": st[-1]}
        return out


class ContinuousBatchingScheduler:
    def __init__(self, engine, max_queue: int = 1024,
                 max_retained: int = 4096):
        self.engine = engine
        self.buckets = tuple(engine.decode_buckets)
        self.max_concurrency = self.buckets[-1]
        self.max_queue = int(max_queue)
        self._queue: deque = deque()
        self._running: dict = {}          # rid -> Request, insertion order
        self._reserved_pages = 0          # pages promised, not yet alloc'd
        self._rid = itertools.count()
        # terminal requests kept for run()/status consumers, bounded to
        # the most recent max_retained per list
        self.max_retained = int(max_retained)
        self.finished: list = []
        self.rejected: list = []
        self.step_times: list = []        # decode-step walltimes (s)
        self.steps = 0
        self._finish_ts: deque = deque(maxlen=64)  # drain-rate window
        # one coarse lock: submit from other threads sees a consistent
        # queue/pool state; step() holds it for the tick
        self._lock = threading.Lock()

    # ----------------------------------------------------------- intake
    def submit(self, prompt_ids, max_new_tokens: int, eos_id=None,
               rid=None) -> Request:
        """Queue one request, or reject it at once: ``max_new<1``
        (prefill always emits a token), ``too_long`` (prompt + max_new
        beyond ``max_seq_len``), ``retry_after`` (queue full; the request
        carries a ``retry_after_s`` hint priced on the recent drain rate)
        or ``pool_too_small`` (the completion needs more pages than the
        pool has)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        with self._lock:
            r = Request(next(self._rid) if rid is None else int(rid),
                        prompt, int(max_new_tokens), eos_id=eos_id)
            pool = self.engine.pool
            total = prompt.shape[0] + r.max_new_tokens
            reason = None
            if r.max_new_tokens < 1:
                reason = "max_new<1"
            elif total > pool.max_seq_len:
                reason = "too_long"
            elif len(self._queue) >= self.max_queue:
                reason = "retry_after"
                r.retry_after_s = self._retry_after_estimate()
            elif pool.pages_needed(total) > pool.num_pages - 1:
                reason = "pool_too_small"
            if reason is not None:
                r.state = "rejected"
                r.reject_reason = reason
                self.rejected.append(r)
                del self.rejected[:-self.max_retained]
                return r
            self._queue.append(r)
            return r

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._running)

    def _retry_after_estimate(self) -> float:
        """Time for the present backlog to drain at the observed
        completion rate, capped at 30 s."""
        backlog = (len(self._queue) + len(self._running)) or 1
        ts = self._finish_ts
        rate = ((len(ts) - 1) / (ts[-1] - ts[0])
                if len(ts) >= 2 and ts[-1] > ts[0] else 0.0)
        est = backlog / rate if rate > 0 else _RETRY_AFTER_CAP_S
        return round(min(max(est, 0.05), _RETRY_AFTER_CAP_S), 3)

    # ------------------------------------------------------------ phases
    def _completion_pages(self, r: Request) -> int:
        return self.engine.pool.pages_needed(
            int(r.prompt.shape[0]) + r.max_new_tokens)

    def _evict_finished(self):
        for rid in [rid for rid, r in self._running.items() if r.done]:
            r = self._running.pop(rid)
            held = len(self.engine.pool.table(rid))
            self._reserved_pages -= self._completion_pages(r) - held
            self.engine.release(rid, token_ids=np.concatenate(
                [r.prompt, np.asarray(r.tokens[:-1], np.int32)]))
            r.state = "finished"
            r.finish_time = time.perf_counter()
            self._finish_ts.append(r.finish_time)
            self.finished.append(r)
            del self.finished[:-self.max_retained]

    def _admit(self):
        pool = self.engine.pool
        while self._queue and len(self._running) < self.max_concurrency:
            r = self._queue[0]
            need = self._completion_pages(r)
            if pool.free_pages - self._reserved_pages < need:
                break  # head-of-line: keep arrival order deterministic
            self._queue.popleft()
            r.admit_time = time.perf_counter()
            tok = self.engine.prefill(r.rid, r.prompt)
            t_done = time.perf_counter()
            r.prefill_s = t_done - r.admit_time
            self._reserved_pages += need - len(pool.table(r.rid))
            r.tokens.append(tok)
            r.state = "running"
            r.first_token_time = t_done
            self._running[r.rid] = r

    def step(self) -> bool:
        """One scheduler tick (evict → admit → one bucketed decode step).
        Returns False when idle (nothing queued or running)."""
        with self._lock:
            self._evict_finished()
            self._admit()
            # admission may have finished short requests (max_new=1)
            active = [r for r in self._running.values() if not r.done]
            if not active:
                return bool(self._queue or self._running)
            t0 = time.perf_counter()
            bucket = self.engine.decode_bucket(len(active))
            pool = self.engine.pool
            for r in active:
                held = len(pool.table(r.rid))
                pool.extend(r.rid, 1)
                self._reserved_pages -= len(pool.table(r.rid)) - held
            toks = self.engine.decode([r.rid for r in active], bucket)
            dt = time.perf_counter() - t0
            for r, t in zip(active, toks):
                r.tokens.append(t)
                r.token_times.append(dt)
            self.steps += 1
            self.step_times.append(dt)
            return True

    def run(self, max_steps: int | None = None) -> list:
        """Drive until drained (or ``max_steps``); returns the finished
        requests in completion order."""
        n = 0
        while self.pending:
            if max_steps is not None and n >= max_steps:
                break
            self.step()
            n += 1
        with self._lock:
            self._evict_finished()
        return self.finished
