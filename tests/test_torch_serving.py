"""The port's serving stack against the reference: the tokenizer, and
``ServingEngine.serve`` on the same weights (``from_jax_params``) giving
the same greedy output ids per request uid, on the CPU.

Worker threads decide which slot a request lands in, so requests are
compared by uid, never by completion order.  Greedy ids are compared
exactly: the f32 logits agree to ~1e-6 relative (``test_torch_lm.py``),
far inside the gap between the two largest logits at these seeds.
"""

import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro.launch import serve as ref_serve_cli  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.config import ModelConfig as RefConfig  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro.serving import tokenizer as ref_tok  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving import tokenizer as tok  # noqa: E402

TEXTS = ["hello, SMOL! ünïcödé", "", "a", "query 7: the quick brown fox", "\x00\xff日本"]
# tests/test_engine_serving.py's engine configuration
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=48, num_heads=4, num_kv_heads=2,
            d_ff=96, vocab_size=tok.VOCAB, head_dim=12, dtype="float32")


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_is_the_reference_tokenizer(text):
    np.testing.assert_array_equal(tok.encode(text), ref_tok.encode(text))
    np.testing.assert_array_equal(tok.encode(text, add_bos=False), ref_tok.encode(text, add_bos=False))
    ids = tok.encode(text)
    assert tok.decode(ids) == ref_tok.decode(ids) == text
    assert (tok.PAD, tok.BOS, tok.EOS, tok.OFFSET, tok.VOCAB) == (
        ref_tok.PAD, ref_tok.BOS, ref_tok.EOS, ref_tok.OFFSET, ref_tok.VOCAB)


def test_encode_batch_is_the_reference():
    got, got_lens = tok.encode_batch(TEXTS, seq_len=9)
    want, want_lens = ref_tok.encode_batch(TEXTS, seq_len=9)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_lens, want_lens)


def _serve_both(ref_cfg, cfg, slots, max_len, n_requests, max_new):
    params = RT.init_lm(ref_cfg, jax.random.PRNGKey(0))
    texts = [f"query {i}: {'xyz' * i}" for i in range(n_requests)]
    ref_reqs = [ref_engine.Request(uid=i, text=t, max_new_tokens=max_new) for i, t in enumerate(texts)]
    ref_done, ref_stats = ref_engine.ServingEngine(params, ref_cfg, batch_slots=slots,
                                                   max_len=max_len).serve(ref_reqs)
    model = T.from_jax_params(jax.tree.map(np.asarray, params), cfg)
    eng = engine.ServingEngine(model, cfg, batch_slots=slots, max_len=max_len, device="cpu")
    reqs = [engine.Request(uid=i, text=t, max_new_tokens=max_new) for i, t in enumerate(texts)]
    done, stats = eng.serve(reqs)
    return ref_done, ref_stats, done, stats, eng


@pytest.mark.parametrize("which", ["tiny", "gemma3-1b"])
def test_serve_matches_reference_per_uid(which):
    if which == "tiny":
        ref_cfg, cfg = RefConfig(**TINY), ModelConfig(**TINY)
        slots, max_len, n, max_new = 2, 48, 3, 4
    else:
        # smoke gemma3: 5 local layers (window 8) + 1 global; prompts (cut
        # to max_len // 2 = 12 tokens) longer than the window; requests run
        # out of room before their budget; idle slots count past max_len
        ref_cfg, cfg = ref_configs.get_smoke_config(which), configs.get_smoke_config(which)
        slots, max_len, n, max_new = 3, 24, 5, 14
    ref_done, ref_stats, done, stats, eng = _serve_both(ref_cfg, cfg, slots, max_len, n, max_new)
    assert stats.completed == ref_stats.completed == n
    want = {r.uid: r.output_ids for r in ref_done}
    got = {r.uid: r.output_ids for r in done}
    assert got == want
    assert all(1 <= len(ids) <= max_new for ids in got.values())
    if which != "tiny":
        assert any(len(ids) < max_new for ids in got.values())  # out of room
    assert all(r.first_token_at is not None and r.finished_at is not None for r in done)
    assert stats.tokens_generated == ref_stats.tokens_generated == sum(map(len, got.values()))
    # every model step is one decode_step: the serve steps plus one per
    # prompt token but the last
    prompt_steps = sum(max(0, len(r.tokens) - 1) for r in done)
    assert eng.model_steps == stats.decode_steps + prompt_steps


def test_engine_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**TINY)
    model = T.init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        engine.ServingEngine(model, cfg)


def test_serve_cli_on_the_cpu(monkeypatch, tmp_path, capsys):
    done, stats = serve_cli.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
                                  "--requests", "3", "--max-new", "3", "--slots", "2",
                                  "--max-len", "48"])
    assert stats.completed == 3 and all(1 <= len(r.output_ids) <= 3 for r in done)
    assert "completed 3 requests" in capsys.readouterr().out
    # the xLSTM stack serves too, with the reference CLI's ids on the same weights
    got, want = _serve_cli_both(monkeypatch, tmp_path, "xlstm-125m", requests=3)
    assert got == want


def _serve_cli_both(monkeypatch, tmp_path, arch: str, requests: int) -> tuple[dict, dict]:
    """The port's and the reference's CLI over one checkpoint that the
    reference's ``save`` wrote: their ids per uid (the port's checks that
    it restored the checkpoint)."""
    params = RT.init_lm(ref_configs.get_smoke_config(arch), jax.random.PRNGKey(5))
    ref_ckpt.save(str(tmp_path), 2, {"params": params})
    argv = ["--arch", arch, "--smoke", "--requests", str(requests), "--max-new", "4", "--slots", "2",
            "--max-len", "32", "--restore", str(tmp_path)]
    served = {}

    class Recording(ref_engine.ServingEngine):
        def serve(self, requests):
            done, stats = super().serve(requests)
            served.update({r.uid: r.output_ids for r in done})
            return done, stats

    monkeypatch.setattr(ref_serve_cli, "ServingEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with redirect_stdout(io.StringIO()):
        ref_serve_cli.main()
    out = io.StringIO()
    with redirect_stdout(out):
        done, stats = serve_cli.main([*argv, "--device", "cpu"])
    assert "restored params from step 2" in out.getvalue()
    assert stats.completed == requests
    return {r.uid: r.output_ids for r in done}, served


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internlm2-1.8b", "hymba-1.5b"])
def test_serve_cli_restores_a_reference_checkpoint(monkeypatch, tmp_path, arch):
    """``--restore DIR`` serves the weights of a checkpoint the reference's
    ``save`` wrote: the port's CLI gives the reference CLI's ids per uid on
    the same checkpoint."""
    got, want = _serve_cli_both(monkeypatch, tmp_path, arch, requests=3)
    assert got == want
