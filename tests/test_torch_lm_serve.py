"""The port's LM slot server (`repro_torch.launch.serve`) against repro's.

The counterparts of the reference's three slot-server tests (the batched
whole-prompt prefill bit-identical to a token-by-token loop, the empty
prompt refused, every request served through reused slots); the port's
server on the reference server's own parameters (`srv.params` carried
across as numpy), each decode step's logits within BF16_TOL of the
largest reference logit (bf16 compute on both sides; see
`tests/test_torch_decode.py`) and the greedy tokens equal wherever the
reference's top two logits lie further apart than that; the slots of a
recurrent model's server kept apart (mamba2, recurrentgemma), each
request's tokens held against the reference's model decoding it alone
(not against the reference's server, whose recurrent slots leak into
each other); `ByteTokenizer` round trips; and the CLI on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, reduced
from repro_torch.data import ByteTokenizer
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, SlotServer
from repro_torch.models import build_model, from_numpy_params

BF16_TOL = 3e-2


def _model():
    return build_model(reduced(get_config("llama3.2-3b")))


def test_slot_server_batched_prefill_matches_token_loop():
    """The batched whole-prompt prefill reproduces the token-by-token
    decode-path prefill: the same greedy tokens for every request, bit
    for bit (both paths run the same decode step on the same inputs)."""
    model = _model()
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=(6 + i % 3,))
               for i in range(4)]

    def run(feed_loop):
        srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=5,
                         device="cpu")
        if feed_loop:
            def _loop_feed(slot, req):
                logits = None
                for t in req.prompt:
                    tok = srv.cur_tok.copy()
                    tok[slot] = t
                    logits, srv.cache = srv._step(
                        srv.params, srv.cache, torch.tensor(tok),
                        torch.tensor(srv.pos))
                    srv.pos[slot] += 1
                srv.cur_tok[slot] = int(torch.argmax(logits[slot]))
            srv._feed_prompt = _loop_feed
        done = srv.run([Request(i, p) for i, p in enumerate(prompts)])
        return {r.rid: r.generated for r in done}

    fast = run(feed_loop=False)
    ref = run(feed_loop=True)
    assert fast == ref
    assert all(len(v) == 5 for v in fast.values())


def test_slot_server_rejects_empty_prompt():
    srv = SlotServer(_model(), slots=1, max_seq=16, eos=None, max_gen=2,
                     device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit(Request(0, np.zeros((0,), np.int64)))


def test_slot_server_serves_all_requests():
    model = _model()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, model.cfg.vocab, size=(4,)))
            for i in range(5)]
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device="cpu")
    done = srv.run(reqs)
    assert len(done) == 5
    assert all(len(r.generated) == 6 for r in done)
    assert all(r.done for r in done)


def test_slot_server_steps_match_reference_server():
    _steps_match_reference_server("llama3.2-3b")


def test_mixtral_slot_server_steps_match_reference_server():
    """The same, for reduced mixtral: its MoE FFN at full capacity in
    every decode step, and its 8-token sliding window."""
    _steps_match_reference_server("mixtral-8x22b")


def _steps_match_reference_server(name):
    """The same requests through the reference's SlotServer and the
    port's, on the reference server's parameters. The two servers make
    the same sequence of decode calls (the schedule depends on the prompt
    lengths and max_gen only), and the port's call i is fed the tokens
    and positions of the reference's call i, so a near tie that flips a
    greedy token cannot make the runs drift apart. Every call's logits
    lie within BF16_TOL of the largest reference logit, and the port's
    greedy token equals the reference's wherever the reference's top two
    logits are further apart than that."""
    jcfg = jreduced(jget_config(name))
    jsrv = jserve.SlotServer(jbuild_model(jcfg), slots=2, max_seq=32,
                             eos=None, max_gen=6)
    model = build_model(reduced(get_config(name)))
    params = from_numpy_params(model.cfg, jax.tree.map(np.asarray,
                                                       jsrv.params),
                               device="cpu")
    srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                     device="cpu", params=params)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab, size=(3 + i % 4,))
               for i in range(5)]
    jrec, rec = [], []
    jstep, step = jsrv._step, srv._step

    def jwrapped(p, cache, tok, pos):
        logits, cache = jstep(p, cache, tok, pos)
        # copies: on the CPU a jax array may alias the server's numpy
        # buffers, which the server updates after the call
        jrec.append((np.array(tok), np.array(pos),
                     np.array(logits, np.float32)))
        return logits, cache

    def wrapped(p, cache, tok, pos):
        jt, jp, _ = jrec[len(rec)]
        logits, cache = step(p, cache, torch.tensor(jt), torch.tensor(jp))
        rec.append(logits.numpy())
        return logits, cache

    jsrv._step, srv._step = jwrapped, wrapped
    jdone = jsrv.run([jserve.Request(i, p) for i, p in enumerate(prompts)])
    done = srv.run([Request(i, p) for i, p in enumerate(prompts)])
    assert len(done) == len(jdone) == 5 and len(rec) == len(jrec) == 39
    clear_steps = 0
    for (_, _, jl), lg in zip(jrec, rec):
        top = float(np.abs(jl).max())
        np.testing.assert_allclose(lg, jl, rtol=0, atol=BF16_TOL * top)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > BF16_TOL * top
        np.testing.assert_array_equal(lg.argmax(-1)[clear],
                                      jl.argmax(-1)[clear])
        clear_steps += int(clear.any())
    assert clear_steps > 0


def _reference_alone(jm, step, jp, prompt, first, served
                     ) -> tuple[int, int]:
    """The reference's `decode_step` decoding one request alone from a
    fresh batch-1 cache, fed what the server fed it: the prompt token by
    token, then the port's own first token (`first`, the server's argmax
    at the prompt's end), each later step the port's served token. Returns
    (positions whose top two reference logits lie further apart than
    BF16_TOL of the largest, those of them where the port's token there
    is the reference's argmax), the prompt's last position counted as the
    others: bf16 on both sides, so a near tie may flip, as in
    `_steps_match_reference_server`, and the reference then continues
    from the port's token all the same. `step` is the reference's jitted
    decode step."""
    cache = jm.init_cache(1, 32)
    for t, tok in enumerate(prompt):
        logits, cache = step(jp, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([t], jnp.int32))
    clear = agree = 0
    tok = first
    for pos, got in enumerate([first] + list(served),
                              start=len(prompt) - 1):
        if pos >= len(prompt):
            logits, cache = step(jp, cache, jnp.asarray([tok], jnp.int32),
                                 jnp.asarray([pos], jnp.int32))
        lg = np.asarray(logits[0])
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] > BF16_TOL * np.abs(lg).max():
            clear += 1
            agree += int(lg.argmax() == got)
        tok = got
    return clear, agree


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_slot_server_keeps_its_slots_apart(name):
    """A recurrent model's server (2 slots, eager): each request's tokens
    equal (a) the same request served alone, (b) the same request after
    another request has used its slot, and (c) the reference's model
    decoding it alone from a fresh cache, at every position whose top
    two reference logits are clearly apart, the reference fed the port's
    own tokens (its first one from the server's prompt step). The
    reference's own server fails (a) and (b) for these models: its prompt
    steps advance every slot's recurrent state, and a reused slot keeps
    its state."""
    jm = jbuild_model(jreduced(jget_config(name)))
    jp = jm.init(jax.random.PRNGKey(0))
    model = build_model(reduced(get_config(name)))
    params = from_numpy_params(model.cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=(5 + 2 * i,)) for i in range(3)]

    def serve(*runs):
        """Each run's requests through one server, one run after the
        other; {rid: (the first token, the prompt step's argmax, then the
        generated tokens)}."""
        srv = SlotServer(model, slots=2, max_seq=32, eos=None, max_gen=6,
                         device="cpu", params=params)
        first = {}
        feed = srv._feed_prompt

        def feed_prompt(slot, req):     # the server's own first token
            feed(slot, req)
            first[req.rid] = int(srv.cur_tok[slot])
        srv._feed_prompt = feed_prompt
        out = {}
        for run in runs:
            for r in srv.run([Request(i, prompts[i]) for i in run]):
                out[r.rid] = (first[r.rid], r.generated)
        return out

    step = jax.jit(jm.decode_step)
    full = serve([0, 1, 2])   # 0 and 1 together; 2 in a slot one of them used
    for i in range(3):
        alone = serve([i])[i]
        assert full[i] == alone, i
        assert serve([(i + 1) % 3], [i])[i] == alone, i
        clear, agree = _reference_alone(jm, step, jp, prompts[i], *alone)
        assert agree == clear >= 4, (i, clear, agree)


@pytest.mark.parametrize("text", ["hello, world", "", "ümlaut ✓ 漢字",
                                  "tabs\tand\nnewlines"])
def test_byte_tokenizer_round_trips(text):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    ids = tok.encode(text)
    np.testing.assert_array_equal(ids, jtok.encode(text))
    assert ids.dtype == np.int32
    assert tok.decode(ids) == jtok.decode(ids) == text
    with_specials = np.concatenate([[tok.bos], ids, [tok.eos]])
    assert tok.decode(with_specials) == text
    assert (tok.vocab_size, tok.bos, tok.eos) == (258, 256, 257)


def test_serve_cli_refuses_the_encoder_decoder(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "whisper-medium", "--reduced", "--device",
                    "cpu"])
    assert "encoder-decoder" in capsys.readouterr().err


def test_serve_cli_on_the_cpu(capsys):
    assert serve.main(["--arch", "gemma2-9b", "--reduced", "--slots", "2",
                       "--requests", "3", "--prompt-len", "4", "--gen", "4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] completed 3/3 requests" in out
    assert out.count("-> 4 tokens") == 3
