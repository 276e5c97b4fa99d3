"""Web chat app with token streaming, model switching and live device
memory telemetry.

Port of ``vptq_tpu/serving/webapp.py`` (the reference's Gradio app,
vptq/app.py: the model dropdown of community checkpoints at
app.py:19-72, the single-model cache at app.py:91-115, the streamed chat
of app_utils.py:109-164, the live GPU chart of app.py:146-189), built on
the standard library. Serves:

  GET  /            — single-page chat UI (streaming, model dropdown)
  POST /api/chat    — {"messages": [...]} → completion; with
                      {"stream": true} responds as a Server-Sent
                      Events stream of token deltas, terminated by a
                      {"done": true, "tokens_per_s": N} event
  GET  /api/models  — {"models": [names], "current": name}
  POST /api/model   — {"name": ...} → load that model in place of the
                      current one
  GET  /api/stats   — rolling device memory series + last decode tok/s

Generation runs on the request's handler thread, so the first request
captures the generator's decode CUDA graphs there; the memory poll
(``utils/device_monitor.py``) makes no CUDA runtime call that could
break such a capture.

Run: python -m vptq_tpu_torch.serving.webapp --model DIR [--port 7860]
     [--device cuda|cpu]
     torchrun --nproc-per-node 2 -m vptq_tpu_torch.serving.webapp \
         --model DIR --tp 2

Under ``--tp n`` (``n`` ranks of a process group, as the CLI's) rank 0
runs the HTTP server and the telemetry; the other ranks follow
(:func:`follow`): rank 0 hands each request's token ids and generation
arguments, each model switch, and the shutdown to every rank before it
acts, and every rank makes the same ``Generator`` call or load.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from vptq_tpu_torch.utils.device_monitor import DeviceMonitor

_PAGE = """<!doctype html>
<html><head><title>vptq_tpu_torch chat</title><style>
body{font-family:sans-serif;max-width:780px;margin:2em auto}
#log{border:1px solid #ccc;padding:1em;min-height:240px;
     white-space:pre-wrap}
#stats{color:#666;font-size:0.85em;margin-top:0.6em}
textarea{width:100%%}select{margin-bottom:0.6em}</style></head><body>
<h2>vptq_tpu_torch chat</h2>
<select id=model onchange=switchModel()></select>
<div id=log></div>
<textarea id=msg rows=3 placeholder="message"></textarea>
<button onclick=send()>send</button>
<div id=stats></div>
<script>
let messages=[];
async function loadModels(){
  const j=await (await fetch('/api/models')).json();
  const sel=document.getElementById('model');
  sel.innerHTML='';
  for(const m of j.models){
    const o=document.createElement('option');
    o.value=m;o.textContent=m;o.selected=(m===j.current);
    sel.appendChild(o);
  }
}
async function switchModel(){
  const name=document.getElementById('model').value;
  render('[loading '+name+'...]');
  await fetch('/api/model',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({name})});
  messages=[];render('');
}
async function send(){
  const t=document.getElementById('msg').value.trim();
  if(!t)return;
  messages.push({role:'user',content:t});
  document.getElementById('msg').value='';
  const r=await fetch('/api/chat',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({messages,stream:true})});
  const reader=r.body.getReader();
  const dec=new TextDecoder();
  let buf='',text='';
  for(;;){
    const {done,value}=await reader.read();
    if(done)break;
    buf+=dec.decode(value,{stream:true});
    let i;
    while((i=buf.indexOf('\\n\\n'))>=0){
      const line=buf.slice(0,i);buf=buf.slice(i+2);
      if(!line.startsWith('data: '))continue;
      const ev=JSON.parse(line.slice(6));
      if(ev.done){
        document.getElementById('stats').textContent=
          ev.tokens_per_s.toFixed(1)+' tok/s';
      }else{text+=ev.delta;render(text);}
    }
  }
  messages.push({role:'assistant',content:text});
  render('');
}
function render(tail){
  document.getElementById('log').textContent=
    messages.map(m=>m.role+': '+m.content).join('\\n')+
    (tail?'\\nassistant: '+tail:'');
}
setInterval(async()=>{
  const s=await (await fetch('/api/stats')).json();
  const gb=x=>(x/1e9).toFixed(2);
  const n=s.bytes_in_use.length;
  let line='';
  if(n)line='GPU memory: '+gb(s.bytes_in_use[n-1])+' / '+
    gb(s.bytes_limit[n-1])+' GB (peak '+gb(s.peak_bytes[n-1])+')';
  if(s.tokens_per_s)line+=' | '+s.tokens_per_s.toFixed(1)+' tok/s';
  document.getElementById('stats').textContent=line;
},1000);
loadModels();
</script></body></html>"""


class ChatState:
    """What one server serves: the generator and its tokenizer, the
    generation arguments, the switchable models and the telemetry. One
    lock orders generations and model switches."""

    def __init__(self, generator, tokenizer, gen_args, models, current,
                 load_fn, monitor, followers=False):
        self.generator = generator
        self.tokenizer = tokenizer
        self.gen_args = gen_args
        self.models = models  # name -> what load_fn takes
        self.current = current
        self.load_fn = load_fn  # (value) -> (generator, tokenizer or None)
        self.monitor = monitor
        self.tokens_per_s = 0.0
        self.lock = threading.Lock()
        # other ranks follow this server's every generation and load
        self.followers = followers

    def tell(self, *op) -> None:
        """Hand ``op`` to the following ranks (under the lock)."""
        if self.followers:
            from vptq_tpu_torch.parallel.distributed import broadcast_object

            broadcast_object(op)


def _switch_model(st: ChatState, name: str) -> None:
    if name == st.current:
        return
    if name not in st.models:
        raise ValueError(f"unknown model {name!r}")
    if st.load_fn is None:
        raise ValueError("model switching not configured")
    with st.lock:
        st.tell("switch", st.models[name])
        # a failed load (a bad path, a hub id the loader cannot fetch)
        # restores the old generator: it must not brick the server
        old_gen, old_name = st.generator, st.current
        st.generator = None
        try:
            gen, tok = st.load_fn(st.models[name])
        except Exception:
            st.generator, st.current = old_gen, old_name
            raise
        # the old model, its cache and its graph pool go, and the
        # allocator returns their blocks to the card
        device = getattr(old_gen, "device", None)
        del old_gen
        gc.collect()
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        st.generator = gen
        if tok is not None:
            st.tokenizer = tok
        st.current = name


def _generate(st: ChatState, messages, stream_callback=None):
    """Run one chat completion; returns (text, tokens_per_s).

    ``stream_callback(delta_text)`` is invoked per decoded token. Where
    ranks follow, a failing callback (a streaming client gone) stops the
    stream but not the generation, whose collectives the other ranks are
    in: the error is raised once every rank has finished it.
    """
    out_ids = []
    text_so_far = [""]
    lost = []

    def on_token(tok):
        out_ids.append(int(tok))
        if stream_callback is not None and not lost:
            full = st.tokenizer.decode(out_ids, skip_special_tokens=True)
            delta = full[len(text_so_far[0]):]
            text_so_far[0] = full
            if delta:
                try:
                    stream_callback(delta)
                except Exception as e:
                    if not st.followers:
                        raise
                    lost.append(e)

    with st.lock:  # one generation at a time; tokenize inside the lock
        # so a concurrent model switch cannot pair the old tokenizer's
        # ids with the newly loaded model
        ids = st.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True
        )
        kwargs = dict(eos_token_id=st.tokenizer.eos_token_id, **st.gen_args)
        st.tell("generate", ids, kwargs)
        start = time.perf_counter()
        out = st.generator.generate(ids, stream_callback=on_token, **kwargs)
        elapsed = time.perf_counter() - start
    if lost:
        raise lost[0]
    text = st.tokenizer.decode(out, skip_special_tokens=True)
    tok_s = len(out) / max(elapsed, 1e-9)
    st.tokens_per_s = tok_s
    return text, tok_s


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    @property
    def state(self) -> ChatState:
        return self.server.state

    def _send(self, code, body, ctype="application/json"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/index"):
            self._send(200, _PAGE, "text/html")
        elif self.path == "/api/stats":
            stats = self.state.monitor.series()
            stats["tokens_per_s"] = self.state.tokens_per_s
            self._send(200, json.dumps(stats))
        elif self.path == "/api/models":
            self._send(200, json.dumps({
                "models": list(self.state.models),
                "current": self.state.current,
            }))
        else:
            self._send(404, json.dumps({"error": "not found"}))

    def _sse_event(self, obj) -> None:
        self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
        self.wfile.flush()

    def _chat(self, payload) -> None:
        messages = payload.get("messages", [])
        if not messages:
            raise ValueError("messages required")
        if payload.get("stream"):
            # SSE: headers first, then one event per token delta.
            # After the headers are out a failure must be reported
            # as an SSE event: a second HTTP response would be an
            # invalid interleaved reply and hang the client reader.
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                content, tok_s = _generate(
                    self.state, messages,
                    stream_callback=lambda d: self._sse_event({"delta": d}),
                )
            except Exception as e:
                self._sse_event({"done": True, "error": str(e)})
                return
            self._sse_event({
                "done": True, "content": content, "tokens_per_s": tok_s,
            })
            return
        content, tok_s = _generate(self.state, messages)
        self._send(200, json.dumps({
            "content": content, "tokens_per_s": tok_s,
        }))

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/api/chat":
                self._chat(payload)
            elif self.path == "/api/model":
                _switch_model(self.state, payload.get("name", ""))
                self._send(
                    200, json.dumps({"current": self.state.current})
                )
            else:
                self._send(404, json.dumps({"error": "not found"}))
        except Exception as e:  # surface errors to the client
            self._send(500, json.dumps({"error": str(e)}))


class ChatServer(ThreadingHTTPServer):
    """The HTTP server and its :class:`ChatState`; ``server_close`` also
    stops the memory poll and the following ranks."""

    def __init__(self, address, state: ChatState):
        self.state = state
        super().__init__(address, Handler)

    def server_close(self):
        super().server_close()
        self.state.monitor.stop()
        with self.state.lock:
            self.state.tell("stop")
            self.state.followers = False


def serve(generator, tokenizer, port=7860, gen_args=None,
          models=None, current="", load_fn=None,
          followers=False) -> ChatServer:
    """A server (not yet serving: call ``serve_forever``) for
    ``generator``, whose ``device`` the memory telemetry watches.
    ``followers``: rank 0 of a process group whose other ranks run
    :func:`follow`."""
    state = ChatState(
        generator, tokenizer,
        gen_args=gen_args or {"max_new_tokens": 256, "temperature": 0.7},
        models=dict(models or {}), current=current, load_fn=load_fn,
        monitor=DeviceMonitor(generator.device).start(),
        followers=followers,
    )
    httpd = ChatServer(("0.0.0.0", port), state)
    print(f"serving on http://0.0.0.0:{httpd.server_address[1]}",
          file=sys.stderr)
    return httpd


def follow(generator, load_fn) -> None:
    """A rank other than 0 under ``--tp``: take each operation rank 0's
    server hands out, in its order, until the server stops: a
    generation (the same ``Generator`` call, its tokens left to rank 0;
    one that rank 0 refuses to the client, such as a prompt longer than
    the cache, this rank refuses alike and goes on) or a model switch (a
    failed load keeps the current model, as rank 0's does)."""
    from vptq_tpu_torch.parallel.distributed import broadcast_object

    while True:
        op = broadcast_object(None)
        if op[0] == "stop":
            return
        if op[0] == "generate":
            try:
                generator.generate(op[1], **op[2])
            except ValueError:
                pass
        elif op[0] == "switch":
            old, generator = generator, None
            try:
                generator = load_fn(op[1])[0]
            except Exception:
                generator = old
            else:
                del old
                gc.collect()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--model", action="append", required=True,
        help="checkpoint dir (repeatable; first is loaded, the rest "
             "populate the dropdown)",
    )
    p.add_argument("--tokenizer", default="")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument(
        "--runtime-format", default="int8",
        choices=(
            "int8", "int4", "int4-mixed", "int3", "int3-mixed",
            "int2", "int2-mixed",
            "bf16", "codebook",
        ),
    )
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--max-seq", type=int, default=2048)
    p.add_argument(
        "--community-models", action="store_true",
        help="add the known community checkpoints' hub ids to the "
             "dropdown (the loader reads local directories only, so "
             "selecting one fails and keeps the current model)",
    )
    p.add_argument(
        "--tp", type=int, default=0,
        help="tensor parallelism over this many ranks of a process group "
        "(launch under torchrun --nproc-per-node N): rank 0 serves HTTP, "
        "the others follow",
    )
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cuda or cpu)")
    return p


def start(args) -> ChatServer:
    """The loaded model's server on rank 0 (not yet serving), or, on a
    following rank under ``--tp``, :func:`follow` until rank 0's server
    closes, then None."""
    from vptq_tpu_torch.models.loader import entry_device, load_model
    from vptq_tpu_torch.serving.cli import _tp_mesh
    from vptq_tpu_torch.serving.generate import Generator

    device = entry_device(args.device)
    mesh = _tp_mesh(args)

    from transformers import AutoTokenizer

    def load_fn(path):
        model = load_model(
            path, dtype=torch.bfloat16,
            runtime_format=args.runtime_format,
            device=None if mesh is not None else device, mesh=mesh,
        )
        gen = Generator(model, max_seq=args.max_seq, mesh=mesh)
        try:
            tok = AutoTokenizer.from_pretrained(path)
        except Exception:  # a checkpoint without one keeps the current
            tok = None
        return gen, tok

    models = {m: m for m in args.model}
    if args.community_models:
        from vptq_tpu_torch.models.registry import COMMUNITY_MODELS

        models.update({mid: mid for mid, _bits in COMMUNITY_MODELS})

    first = args.model[0]
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer or first)
    gen, _ = load_fn(first)
    if mesh is not None and mesh.rank != 0:
        follow(gen, load_fn)
        return None
    return serve(
        gen, tokenizer, port=args.port,
        gen_args={
            "max_new_tokens": args.max_new_tokens,
            "temperature": args.temperature,
        },
        models=models, current=first, load_fn=load_fn,
        followers=mesh is not None,
    )


def main(argv=None) -> int:
    httpd = start(build_parser().parse_args(argv))
    if httpd is None:
        return 0
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
