"""The port's web app against vptq_tpu's.

The four behaviours tests/test_webapp.py pins, on its fakes (each given
the device the memory telemetry watches), and a real port ``Generator``
on the CPU whose chat content, as JSON and as Server-Sent Events, is the
JAX web app's on the same checkpoint and byte tokenizer (both models in
f32, the JAX side's Pallas kernels in interpret mode).
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_port import TINY, VQ

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.serving import webapp as jwebapp
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving import webapp
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils.synth_tokenizer import write_byte_tokenizer


class _FakeTokenizer:
    eos_token_id = 0

    def apply_chat_template(self, messages, add_generation_prompt=True):
        return [1, 2, 3]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


class _FakeGenerator:
    device = torch.device("cpu")

    def generate(self, ids, eos_token_id=None, stream_callback=None, **kw):
        out = [7, 8, 9]
        if stream_callback is not None:
            for t in out:
                stream_callback(t)
        return out


def _running(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", t


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req)


def _events(resp):
    return [
        json.loads(line[len("data: "):])
        for line in resp.read().decode().split("\n\n")
        if line.startswith("data: ")
    ]


def test_webapp_endpoints():
    httpd = webapp.serve(_FakeGenerator(), _FakeTokenizer(), port=0)
    base, t = _running(httpd)
    try:
        html = urllib.request.urlopen(base + "/").read().decode()
        assert "vptq_tpu_torch chat" in html and "GPU memory" in html
        assert "TPU" not in html

        stats = json.loads(urllib.request.urlopen(base + "/api/stats").read())
        assert set(stats) == {"time", "bytes_in_use", "bytes_limit",
                              "peak_bytes", "tokens_per_s"}
        # the CPU reports zeros, as vptq_tpu's monitor does on a CPU
        assert stats["bytes_in_use"][-1:] == [0]

        msg = {"messages": [{"role": "user", "content": "hi"}]}
        resp = json.loads(_post(base, "/api/chat", msg).read())
        assert resp["content"] == "7 8 9"
        assert resp["tokens_per_s"] > 0

        # tokens/s lands in the stats line after a completion
        stats = json.loads(urllib.request.urlopen(base + "/api/stats").read())
        assert stats["tokens_per_s"] > 0

        # SSE streaming: per-token deltas then a done event
        r = _post(base, "/api/chat", dict(msg, stream=True))
        assert r.headers["Content-Type"] == "text/event-stream"
        events = _events(r)
        assert events[-1]["done"] is True
        assert events[-1]["content"] == "7 8 9"
        assert events[-1]["tokens_per_s"] > 0
        assert "".join(e["delta"] for e in events[:-1]) == "7 8 9"

        # error path: empty payload
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/api/chat", {})
        assert e.value.code == 500
    finally:
        _stop(httpd, t)
    assert not httpd.state.monitor._thread.is_alive()


def test_webapp_model_switch():
    loads = []

    def load_fn(path):
        loads.append(path)
        return _FakeGenerator(), _FakeTokenizer()

    httpd = webapp.serve(
        _FakeGenerator(), _FakeTokenizer(), port=0,
        models={"a": "/ckpt/a", "b": "/ckpt/b"}, current="a", load_fn=load_fn,
    )
    base, t = _running(httpd)
    try:
        models = json.loads(urllib.request.urlopen(base + "/api/models").read())
        assert models == {"models": ["a", "b"], "current": "a"}
        assert json.loads(_post(base, "/api/model", {"name": "b"}).read()) == {
            "current": "b"}
        assert loads == ["/ckpt/b"]
        # switching to the already-current model is a no-op
        assert json.loads(_post(base, "/api/model", {"name": "b"}).read()) == {
            "current": "b"}
        assert loads == ["/ckpt/b"]
        # unknown model -> 500 with the error surfaced
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/api/model", {"name": "zzz"})
        assert e.value.code == 500
        assert "zzz" in json.loads(e.value.read())["error"]
    finally:
        _stop(httpd, t)


def test_webapp_switch_failure_keeps_old_model():
    """A failing model switch restores the previous generator."""

    def bad_load(path):
        raise RuntimeError("no checkpoint at " + path)

    gen = _FakeGenerator()
    httpd = webapp.serve(
        gen, _FakeTokenizer(), port=0, models={"good": "good", "bad": "bad"},
        current="good", load_fn=bad_load,
    )
    base, t = _running(httpd)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/api/model", {"name": "bad"})
        assert e.value.code == 500
        assert httpd.state.generator is gen
        assert httpd.state.current == "good"
        # chat still works on the restored model
        msg = {"messages": [{"role": "user", "content": "hi"}]}
        assert json.loads(_post(base, "/api/chat", msg).read())[
            "content"] == "7 8 9"
    finally:
        _stop(httpd, t)


def test_webapp_stream_error_is_sse_event():
    """A generation failure after the SSE headers arrives as a done+error
    event, not as an interleaved second HTTP response."""

    class _Boom(_FakeGenerator):
        def generate(self, *a, **kw):
            raise RuntimeError("device fell over")

    httpd = webapp.serve(_Boom(), _FakeTokenizer(), port=0)
    base, t = _running(httpd)
    try:
        msg = {"messages": [{"role": "user", "content": "hi"}],
               "stream": True}
        with _post(base, "/api/chat", msg) as r:
            assert r.status == 200
            events = _events(r)
        assert events and events[-1]["done"]
        assert "device fell over" in events[-1]["error"]
    finally:
        _stop(httpd, t)


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(
        sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas"
    )
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    jax.clear_caches()


def test_chat_content_equals_jax(tmp_path, jax_pallas):
    """A real port Generator (int8, f32, CPU) behind the port's web app
    and vptq_tpu's behind its own, on one checkpoint and byte tokenizer:
    the same content as JSON and as SSE, two turns."""
    from transformers import AutoTokenizer

    cfg = dict(TINY, vocab_size=272, tie_word_embeddings=False)
    jsc.write_synthetic_checkpoint(
        str(tmp_path), jsc.tiny_model_config(**cfg), vq_kwargs=VQ, seed=5)
    write_byte_tokenizer(str(tmp_path), vocab_size=272)
    tok = AutoTokenizer.from_pretrained(str(tmp_path))
    gen_args = {"max_new_tokens": 8, "temperature": 0.0}
    jmodel = j_load_model(str(tmp_path), dtype=jnp.float32,
                          runtime_format="int8")
    tmodel = load_model(str(tmp_path), dtype=torch.float32,
                        runtime_format="int8", device="cpu")
    servers = [
        jwebapp.serve(JGenerator(jmodel, max_seq=128, dtype=jnp.float32),
                      tok, port=0, gen_args=gen_args),
        webapp.serve(Generator(tmodel, max_seq=128, dtype=torch.float32),
                     tok, port=0, gen_args=gen_args),
    ]
    running = [_running(h) for h in servers]
    try:
        messages = [{"role": "system", "content": "be brief"},
                    {"role": "user", "content": "hello there"}]
        contents = []
        for base, _ in running:
            turns = []
            for msgs in (messages, messages[1:]):
                content = json.loads(_post(
                    base, "/api/chat", {"messages": msgs}).read())["content"]
                events = _events(_post(
                    base, "/api/chat", {"messages": msgs, "stream": True}))
                assert events[-1]["content"] == content
                assert "".join(e["delta"] for e in events[:-1]) == content
                turns.append(content)
            contents.append(turns)
        assert contents[1] == contents[0]
        assert any(contents[0])
    finally:
        for h, (_, t) in zip(servers, running):
            h.shutdown()
            h.server_close()
            t.join(timeout=10)
    jwebapp._State.monitor.stop()


def test_community_models_are_listed_and_fail_in_the_loader(tmp_path):
    """``--community-models`` lists vptq_tpu's hub ids; the port's loader
    reads local directories only, so selecting one fails there (and the
    web app keeps its model, as ``test_webapp_switch_failure_keeps_old_
    model`` holds)."""
    from vptq_tpu.models import registry as jregistry
    from vptq_tpu_torch.models import registry

    assert registry.COMMUNITY_MODELS == jregistry.COMMUNITY_MODELS
    assert registry.SUPPORTED_FAMILIES == jregistry.SUPPORTED_FAMILIES
    with pytest.raises(FileNotFoundError):
        load_model(registry.COMMUNITY_MODELS[0][0], device="cpu")
