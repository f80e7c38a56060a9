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

On the card every model step is one replay of a CUDA graph
(:class:`DecodeGraph`), the counterpart of the reference's ``jax.jit``
over its decode step: one per (slots, max_len, cache dtype), captured at
the engine's first serve (or :meth:`ServingEngine.warm`), over a cache
the engine keeps and zeroes in place at each serve.  A step is one
pinned copy in, one replay, and — where the serve loop reads the next
tokens — one copy of the B greedy ids out (the argmax runs on the card).
``cuda_graph=False`` runs the same steps eagerly; ``device="cpu"`` is
always eager.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
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


def slots_and_length(cache: dict) -> tuple[int, int | None]:
    """(batch slots, max_len) of a decode cache: the slots from axis 1 of
    any leaf; the length from a leaf whose axis 2 is the self-attention
    sequence (``decode.CACHE_DIM_SEMANTICS``; an encoder-decoder's cross
    K/V are S_enc long, not max_len), None where no leaf has one (the
    xLSTM's recurrent state)."""
    slots = next(iter(cache.values())).shape[1]
    length = next((v.shape[2] for name, v in cache.items() if D.CACHE_DIM_SEMANTICS[name][2] == "seq"), None)
    return slots, length


class DecodeGraph:
    """``decode_step`` over one cache, captured as one CUDA graph.

    Static tensors, each at one address for the graph's lifetime: ``inp``
    (2, B) int32, the token ids and the cache lengths; the cache, which
    every replay updates in place; the outputs ``logits`` (B, V) and
    ``ids`` (B,), the greedy argmax taken on the card.  ``kernel_launches``
    holds the K3/K4/K6 launches the graph recorded: what one replay launches,
    since a replay bypasses the wrappers' counters.

    The hazards of capturing a decode step, and where they are handled:

    * No host sync inside the step: ``decode_step`` and the MoE dispatch
      (``models/layers.py``) make none.
    * K4's arrival counters are kept per (device, stream)
      (``kernels/decode_attention/ops.py``): the graph is captured on a
      stream of its own, on which nothing else launches, and holds that
      stream, so no eager K4 call shares the counters a replay uses and
      they are never replaced.
    * Frozen host state: K4 builds the TMA bulk copies' addresses from the
      cache slices at capture, so the cache is never reallocated, only
      written in place (and zeroed in place between serves).
    * The eager run before the capture (cuBLAS handles and workspaces, the
      kernel library, K4's counters — none of which may be created inside
      a capture) runs with every length at the cache's end
      (:func:`slots_and_length`: the self-attention cache's, not an
      encoder's S_enc), where ``decode_step`` drops the row it would
      write.  It still advances the recurrent states
      (``decode.RECURRENT``: Mamba's, the mLSTM's and sLSTM's), so they are
      copied before it and written back in place after it: the run leaves
      the cache as it was, and a graph built over a prefilled cache
      replays from the prefill's state.
    * An encoder-decoder's cross K/V are read in place, at the addresses
      they had at capture (zeroed in place between serves like the rest).
    """

    def __init__(self, params, cfg: ModelConfig, cache: dict, kv_repeat: int = 1):
        b, s = slots_and_length(cache)
        dev = next(iter(cache.values())).device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a cache on the card, got {dev}")
        self.cache = cache
        self.inp = torch.zeros((2, b), dtype=torch.int32, device=dev)
        self.inp[1].fill_(s or 0)  # past the cache: the warm-up writes no row
        saved = {name: buf.clone() for name, buf in cache.items() if name in D.RECURRENT}

        def step():
            logits, _, _ = D.decode_step(params, cfg, self.inp[0], cache, self.inp[1], kv_repeat)
            return logits, torch.argmax(logits, dim=-1)

        counters = {"flash_attention": flash_ops.flash_attention_bshd,
                    "decode_attention": decode_ops.decode_attention_cache,
                    "selective_scan": scan_ops.selective_scan}
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            step()
        self.stream.synchronize()
        for name, buf in saved.items():
            cache[name].copy_(buf)
        del saved
        before = {name: fn.launches for name, fn in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, stream=self.stream, capture_error_mode="thread_local"):
            self.logits, self.ids = step()
        self.capture_seconds = time.perf_counter() - t0
        self.kernel_launches = {name: fn.launches - before[name] for name, fn in counters.items()}
        self.replays = 0
        self._ids_host = torch.empty(b, dtype=torch.int64, pin_memory=True)
        self._ids_ready = torch.cuda.Event()

    def run(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """One replay on tensors (on the card or the host): the static
        logits, which the next replay overwrites."""
        self.inp[0].copy_(tokens)
        self.inp[1].copy_(lengths)
        self.graph.replay()
        self.replays += 1
        return self.logits

    def step(self, tokens: np.ndarray, lengths: np.ndarray, read_ids: bool = True) -> np.ndarray | None:
        """One replay on host arrays: one pinned copy in (the pinned block
        is not reused before the copy has run), the replay, and with
        ``read_ids`` the greedy ids copied out."""
        src = torch.from_numpy(np.stack([tokens, lengths]).astype(np.int32)).pin_memory()
        self.inp.copy_(src, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        if not read_ids:
            return None
        self._ids_host.copy_(self.ids, non_blocking=True)
        self._ids_ready.record()
        self._ids_ready.synchronize()
        return self._ids_host.numpy().copy()


class ServingEngine:
    """Slot-based batched serving for one model on one device
    (``"cuda"`` by default; the model is moved there), greedy sampling.
    On the card each model step is a replay of a :class:`DecodeGraph`
    unless ``cuda_graph`` is False; a capture that fails raises."""

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        batch_slots: int = 8,
        max_len: int = 256,
        num_workers: int = 2,
        cache_dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = "cuda",
        cuda_graph: bool = True,
    ):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.num_workers = num_workers
        self.cache_dtype = cache_dtype
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        # the step captured at this engine's (slots, max_len, cache dtype), with its cache
        self.decode_graph: DecodeGraph | None = None
        # forward passes of the model (serve steps + prompt steps) of the last serve()
        self.model_steps = 0

    def warm(self) -> DecodeGraph | None:
        """Capture this engine's decode graph now (a no-op when eager)."""
        if self.cuda_graph and self.decode_graph is None:
            cache = D.init_cache(self.cfg, self.slots, self.max_len, dtype=self.cache_dtype,
                                 device=self.device)
            self.decode_graph = DecodeGraph(self.params, self.cfg, cache)
        return self.decode_graph

    def _fresh_cache(self) -> dict:
        graph = self.warm()
        if graph is None:
            return D.init_cache(self.cfg, self.slots, self.max_len, dtype=self.cache_dtype,
                                device=self.device)
        for buf in graph.cache.values():
            buf.zero_()
        return graph.cache

    def _decode(self, tok_ids: np.ndarray, cache: dict, lens: np.ndarray,
                read_ids: bool = True) -> np.ndarray | None:
        """One model step; with ``read_ids`` the greedy next ids (B,)."""
        self.model_steps += 1
        if self.cuda_graph:
            return self.warm().step(tok_ids, lens, read_ids)
        logits, _, _ = D.decode_step(
            self.params, self.cfg, torch.from_numpy(tok_ids).to(self.device), cache,
            torch.from_numpy(lens).to(self.device),
        )
        return torch.argmax(logits, dim=-1).cpu().numpy() if read_ids else None

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
        cache = self._fresh_cache()
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
            nxt = self._decode(cur_tok, cache, lens)
            lens += 1
            decode_steps += 1
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
            self._decode(one, cache, lens, read_ids=False)
            lens[slot] += 1
        return int(prompt[-1]) if len(prompt) else tok.BOS
