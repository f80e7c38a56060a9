"""Batched serving engine of the port: ``repro.serving.engine`` on torch.

Request preprocessing (tokenization) runs on host worker threads and
feeds a queue while the card runs the decode steps; fixed batch slots are
refilled from that queue between steps.  The slot semantics are the
reference's, step for step:

* a new request's prompt enters its slot through ``decode_step`` calls,
  one token each, with the other slots' lengths frozen (their rows are
  rewritten at their frozen positions and overwritten by their next real
  token, as in the reference);
* every serve step decodes all slots, idle ones included, and all
  lengths advance;
* a slot finishes on its token budget, on EOS, or when its length reaches
  ``max_len - 1``.

The lengths live on the host (one small copy per step) and the cache on
the card, updated in place by ``decode_step``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode as D
from repro_torch.models.config import ModelConfig
from repro_torch.serving import tokenizer as tok


@dataclasses.dataclass
class Request:
    uid: int
    text: str
    max_new_tokens: int = 32
    tokens: np.ndarray | None = None
    output_ids: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: float | None = None
    finished_at: float | None = None


@dataclasses.dataclass
class ServeStats:
    completed: int
    wall_seconds: float
    decode_steps: int
    tokens_generated: int

    @property
    def tokens_per_second(self) -> float:
        return self.tokens_generated / self.wall_seconds if self.wall_seconds else 0.0


class ServingEngine:
    """Slot-based batched serving for one model on one device
    (``"cuda"`` by default; the model is moved there), greedy sampling."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        batch_slots: int = 8,
        max_len: int = 256,
        num_workers: int = 2,
        cache_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = "cuda",
    ):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.num_workers = num_workers
        self.cache_dtype = cache_dtype
        # forward passes of the model (serve steps + prompt steps) of the last serve()
        self.model_steps = 0

    def _decode(self, tok_ids: np.ndarray, cache: dict, lens: np.ndarray) -> torch.Tensor:
        self.model_steps += 1
        logits, _, _ = D.decode_step(
            self.params, self.cfg, torch.from_numpy(tok_ids).to(self.device), cache,
            torch.from_numpy(lens).to(self.device),
        )
        return logits

    # --------------------------------------------------------------- public
    def serve(self, requests: list[Request]) -> tuple[list[Request], ServeStats]:
        """Run all requests to completion with pipelined tokenize+decode."""
        ready: queue.Queue = queue.Queue()
        pending = list(requests)
        t_start = time.perf_counter()
        self.model_steps = 0

        def worker(wid: int):
            for i in range(wid, len(pending), self.num_workers):
                r = pending[i]
                r.tokens = tok.encode(r.text)[: self.max_len // 2]
                ready.put(r)

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        # slot state
        cache = D.init_cache(self.cfg, self.slots, self.max_len, dtype=self.cache_dtype,
                             device=self.device)
        lens = np.zeros((self.slots,), np.int32)
        cur_tok = np.zeros((self.slots,), np.int32)
        slot_req: list[Request | None] = [None] * self.slots
        slot_budget = np.zeros((self.slots,), np.int64)
        completed: list[Request] = []
        decode_steps = 0
        tokens_generated = 0

        def try_fill_slots():
            for s in range(self.slots):
                if slot_req[s] is not None:
                    continue
                try:
                    r = ready.get_nowait()
                except queue.Empty:
                    return
                cur_tok[s] = self._slot_prefill(r.tokens, cache, lens, s)
                slot_req[s] = r
                slot_budget[s] = r.max_new_tokens

        while len(completed) < len(pending):
            try_fill_slots()
            if all(r is None for r in slot_req):
                time.sleep(0.001)
                continue
            logits = self._decode(cur_tok, cache, lens)
            lens += 1
            decode_steps += 1
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for s in range(self.slots):
                r = slot_req[s]
                if r is None:
                    continue
                if r.first_token_at is None:
                    r.first_token_at = time.perf_counter()
                r.output_ids.append(int(nxt[s]))
                tokens_generated += 1
                slot_budget[s] -= 1
                hit_eos = int(nxt[s]) == tok.EOS
                out_of_room = int(lens[s]) >= self.max_len - 1
                if slot_budget[s] <= 0 or hit_eos or out_of_room:
                    r.finished_at = time.perf_counter()
                    completed.append(r)
                    slot_req[s] = None
                else:
                    cur_tok[s] = int(nxt[s])
        for t in threads:
            t.join()
        stats = ServeStats(
            completed=len(completed),
            wall_seconds=time.perf_counter() - t_start,
            decode_steps=decode_steps,
            tokens_generated=tokens_generated,
        )
        return completed, stats

    # -------------------------------------------------------------- helpers
    def _slot_prefill(self, prompt: np.ndarray, cache: dict, lens: np.ndarray, slot: int) -> int:
        """Feed a prompt into one slot by stepping tokens 0..n-2 through
        ``decode_step`` (only this slot's length advances); the serve loop
        then feeds the final prompt token and samples the first generated
        token.  ``lens`` is updated in place; returns that final token."""
        lens[slot] = 0
        for t in range(max(0, len(prompt) - 1)):
            one = np.zeros((self.slots,), np.int32)
            one[slot] = prompt[t]
            self._decode(one, cache, lens)
            lens[slot] += 1
        return int(prompt[-1]) if len(prompt) else tok.BOS
