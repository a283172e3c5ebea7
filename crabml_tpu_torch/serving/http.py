"""Minimal OpenAI-style HTTP front-end over ServingEngine.

Counterpart of crabml_tpu/serving/http.py. Stdlib only (http.server): POST
/v1/completions (or /generate) with
  {"prompt": str, "max_tokens": int, "temperature": float, "top_p": float,
   "min_p": float, "repetition_penalty": float, "stop": [...], "stream": bool,
   "logprobs": int (per-token sampled logprob + top-N alternatives on
   responses that are not streamed), "n": int}
-> {"id", "choices": [{"text", "finish_reason"}], "usage": {...}}, or chunked
text/event-stream when "stream" is true. GET /health reports slot occupancy,
/metrics is a Prometheus text exposition, /v1/models lists the model.
/v1/chat/completions answers 501: the chat templates are not ported yet.

The engine loop runs on a dedicated thread and does all device work; handler
threads only enqueue and wait on per-request queues, so many requests in
flight batch continuously onto the slot pool.

    python -m crabml_tpu_torch.serving.http model.gguf --paged
    python -m crabml_tpu_torch.serving.http model.gguf --device cpu --dtype f32
    python -m crabml_tpu_torch.serving.http model.gguf --speculative 4 --draft small.gguf
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.sampler import LOGPROB_TOPK
from .engine import Request, ServingEngine


def make_handler(engine: ServingEngine):
    def uptime() -> float:
        return time.monotonic() - engine._started if engine._started else 0.0

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, "application/json", json.dumps(obj).encode())

        def _error(self, code: int, message: str, etype: str = "invalid_request_error"):
            # OpenAI error envelope: clients read error.message/error.type
            self._json(code, {"error": {
                "message": message, "type": etype, "param": None, "code": None}})

        def do_GET(self):
            if self.path == "/health":
                up = uptime()
                body = {
                    "status": "ok",
                    "model": engine.cfg.model_name,
                    "slots_total": engine.n_slots,
                    "slots_busy": sum(r is not None for r in engine.slots),
                    "steps": engine.steps,
                    "tokens_generated": engine.tokens_generated,
                    "tokens_per_sec": round(engine.tokens_generated / up, 2) if up > 0 else 0.0,
                }
                if hasattr(engine, "pages_free"):
                    body["pages_free"] = engine.pages_free()
                    body["prefix_hits"] = engine.prefix_hits
                    body["prefix_tokens_reused"] = engine.prefix_tokens_reused
                self._json(200, body)
            elif self.path == "/metrics":  # Prometheus text exposition
                rows = [
                    ("crabml_slots_total", "gauge", engine.n_slots),
                    ("crabml_slots_busy", "gauge", sum(r is not None for r in engine.slots)),
                    ("crabml_spec_ticks_total", "counter", engine.spec_ticks),
                    ("crabml_spec_tokens_total", "counter", engine.spec_tokens),
                    ("crabml_requests_submitted_total", "counter", engine.requests_submitted),
                    ("crabml_requests_completed_total", "counter", engine.requests_completed),
                    ("crabml_decode_steps_total", "counter", engine.steps),
                    ("crabml_tokens_generated_total", "counter", engine.tokens_generated),
                    ("crabml_prefill_tokens_total", "counter", engine.prefill_tokens),
                    ("crabml_uptime_seconds", "gauge", round(uptime(), 3)),
                ]
                if hasattr(engine, "pages_free"):
                    rows += [
                        ("crabml_kv_pages_free", "gauge", engine.pages_free()),
                        ("crabml_prefix_hits_total", "counter", engine.prefix_hits),
                        ("crabml_prefix_tokens_reused_total", "counter",
                         engine.prefix_tokens_reused),
                        ("crabml_prefix_evictions_total", "counter", engine.prefix_evictions),
                        ("crabml_preemptions_total", "counter", engine.preemptions),
                    ]
                body = ("".join(f"# TYPE {n} {t}\n{n} {v}\n" for n, t, v in rows)
                        + engine.ttft_hist.render("crabml_ttft_seconds")
                        + engine.e2e_hist.render("crabml_request_duration_seconds"))
                self._send(200, "text/plain; version=0.0.4", body.encode())
            elif self.path == "/v1/models":  # OpenAI client discovery
                self._json(200, {"object": "list", "data": [{
                    "id": engine.cfg.model_name, "object": "model", "owned_by": "crabml-tpu"}]})
            else:
                self._error(404, "not found", "not_found_error")

        def _build_request(self, payload, prompt: str) -> Request:
            stop = payload.get("stop") or []
            if isinstance(stop, str):  # OpenAI allows a bare string
                stop = [stop]
            if not all(isinstance(s, str) for s in stop):
                raise ValueError("stop must be a string or list of strings")
            lb = payload.get("logit_bias") or {}
            if not isinstance(lb, dict):
                raise ValueError("logit_bias must be a {token_id: bias} map")
            lp = payload.get("logprobs")
            if lp is not None:
                lp = int(lp)
                if not 0 <= lp <= LOGPROB_TOPK:
                    raise ValueError(f"logprobs must be between 0 and {LOGPROB_TOPK}")
            return Request(
                prompt=prompt,
                max_tokens=int(payload.get("max_tokens", 256)),
                temperature=float(payload.get("temperature", 0.0)),
                topp=float(payload.get("top_p", 0.9)),
                minp=float(payload.get("min_p", 0.0)),
                repetition_penalty=float(payload.get("repetition_penalty", 1.0)),
                frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
                presence_penalty=float(payload.get("presence_penalty", 0.0)),
                logit_bias=tuple(sorted((int(k), float(v)) for k, v in lb.items())),
                stop=tuple(s for s in stop if s),
                logprobs=lp,
            )

        def _piece(self, tid: int) -> str:
            return engine.tokenizer.decode_bytes(tid).decode("utf-8", "replace")

        def _logprobs_obj(self, req: Request):
            """OpenAI-shaped logprobs of a finished request (or None),
            aligned with output_tokens."""
            if req.logprobs is None:
                return None
            pairs = list(zip(req.output_tokens, req.output_logprobs))
            obj = {"tokens": [self._piece(t) for t, _ in pairs],
                   "token_logprobs": [l for _, l in pairs]}
            if req.logprobs > 0:
                obj["top_logprobs"] = [{self._piece(tid): tl for tid, tl in top}
                                       for top in req.output_top_logprobs[: len(pairs)]]
            return obj

        def _stream_sse(self, reqs: list[Request], want_usage: bool):
            """Drain the requests' token streams as chunked SSE. A client
            that disconnects mid-stream cancels its requests, so the engine
            stops decoding for nobody."""
            streams = [engine.enqueue_streaming(r) for r in reqs]
            merged: "queue.SimpleQueue" = queue.SimpleQueue()

            def pump(i, st):
                while True:
                    piece = st.get()
                    merged.put((i, piece))
                    if piece is None:
                        return

            for i, st in enumerate(streams):
                threading.Thread(target=pump, args=(i, st), daemon=True).start()
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

            def event(obj):
                chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")

            live = len(reqs)
            try:
                while live:
                    i, piece = merged.get()
                    if piece is None:
                        live -= 1
                    elif len(reqs) > 1:
                        event({"index": i, "text": piece})
                    else:
                        event({"text": piece})
                if want_usage:
                    event({"usage": self._usage(reqs)})
                chunk(b"data: [DONE]\n\n")
                chunk(b"")
            except (BrokenPipeError, ConnectionResetError):
                for r in reqs:
                    engine.cancel(r)

        @staticmethod
        def _usage(reqs: list[Request]) -> dict:
            n_prompt = len(reqs[0].prompt_tokens)
            n_out = sum(len(r.output_tokens) for r in reqs)
            return {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                    "total_tokens": n_prompt + n_out}

        def do_POST(self):
            if self.path == "/v1/chat/completions":
                self._error(501, "chat completions are not ported: the chat templates "
                                 "(runtime.chat.render_messages) are missing; render the "
                                 "conversation yourself and POST it to /v1/completions",
                            "not_implemented_error")
                return
            if self.path not in ("/v1/completions", "/generate", "/tokenize", "/detokenize"):
                self._error(404, "not found", "not_found_error")
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/tokenize":
                    self._json(200, {"tokens": engine.tokenizer.encode(
                        str(payload.get("content", "")),
                        bos=bool(payload.get("add_special", False)))})
                    return
                if self.path == "/detokenize":
                    toks = payload.get("tokens") or []
                    if not all(isinstance(t, int) for t in toks):
                        raise ValueError("tokens must be a list of ints")
                    self._json(200, {"content": engine.tokenizer.decode_tokens(toks)})
                    return
                n_choices = int(payload.get("n", 1))
                if not 1 <= n_choices <= engine.n_slots:
                    raise ValueError(f"n must be between 1 and {engine.n_slots} "
                                     "(the engine's slot count)")
                reqs = [self._build_request(payload, payload.get("prompt", ""))
                        for _ in range(n_choices)]
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._error(400, str(e))
                return

            if payload.get("stream"):
                self._stream_sse(reqs, bool((payload.get("stream_options") or {})
                                            .get("include_usage")))
                return

            streams = [engine.enqueue_streaming(r) for r in reqs]
            texts = []
            for r, stream in zip(reqs, streams):
                parts = []
                while True:
                    piece = stream.get()
                    if piece is None:
                        break
                    parts.append(piece)
                texts.append(r.output_text if r.output_text is not None else "".join(parts))
            if payload.get("echo"):  # OpenAI completions echo
                texts = [reqs[0].prompt + t for t in texts]
            self._json(200, {
                "id": f"cmpl-{reqs[0].request_id}",
                "object": "text_completion",
                "model": engine.cfg.model_name,
                "choices": [{"index": i, "text": texts[i], "logprobs": self._logprobs_obj(r),
                             "finish_reason": r.finish_reason} for i, r in enumerate(reqs)],
                "usage": self._usage(reqs),
            })

    return Handler


def make_server(engine: ServingEngine, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """The HTTP server bound to (host, port); port 0 picks a free one
    (`server.server_address`). The caller runs `serve_forever`."""
    return ThreadingHTTPServer((host, port), make_handler(engine))


def serve(engine: ServingEngine, host: str = "0.0.0.0", port: int = 8000, server=None):
    """Run the engine loop on its own thread and the HTTP server on this one
    until `server.shutdown()` or an interrupt; then stop and join the engine."""
    server = server or make_server(engine, host, port)
    loop = threading.Thread(target=engine.run_forever, daemon=True)
    loop.start()
    try:
        server.serve_forever()
    finally:
        engine.shutdown()
        loop.join()
        server.server_close()


def engine_from_args(argv=None):
    """Parse the daemon's command line and build its engine -> (engine, args)."""
    import argparse

    ap = argparse.ArgumentParser(prog="crabml-tpu-torch-serve")
    ap.add_argument("model", help="path to GGUF model file")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="int8 KV cache or pool (default: the compute dtype)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool (memory scales with tokens in flight)")
    ap.add_argument("--pages", type=int, default=256, help="pool size with --paged")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable automatic prompt-prefix page reuse (--paged)")
    ap.add_argument("--tick-tokens", type=int, default=1,
                    help="decode ticks per engine step while no admission is pending")
    ap.add_argument("--repeat-window", type=int, default=None,
                    help="repetition/frequency/presence penalty window (default 64)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative serving: verify K drafted tokens a slot a step (greedy "
                         "requests take the drafts). Drafts come from prompt lookup, or from "
                         "--draft's small model")
    ap.add_argument("--draft", metavar="GGUF", default=None,
                    help="small draft GGUF for two-model speculative serving (sets the draft "
                         "length to 4 when --speculative is not given)")
    ap.add_argument("--kv-lane-pad", action="store_true",
                    help="accepted as the JAX package's daemon takes it, and changes nothing: "
                         "the attention kernels take head dims 80 and 96 as they are")
    args = ap.parse_args(argv)

    import torch

    from ..runtime.runner import Runner

    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    runner = Runner(args.model, seq_len=args.seq_len, compute_dtype=dt, device=args.device,
                    kv_lane_pad=args.kv_lane_pad, draft_model=args.draft)
    kw = dict(n_slots=args.slots, seq_len=args.seq_len, tick_tokens=args.tick_tokens,
              repeat_window=args.repeat_window, speculative=args.speculative,
              kv_dtype=torch.int8 if args.kv_dtype == "int8" else None)
    if args.paged:
        from .paged import PagedServingEngine

        engine = PagedServingEngine(runner, n_pages=args.pages,
                                    prefix_cache=not args.no_prefix_cache, **kw)
    else:
        engine = ServingEngine(runner, **kw)
    return engine, args


def main(argv=None):
    engine, args = engine_from_args(argv)
    print(f"serving {engine.cfg.model_name} on {args.host}:{args.port} "
          f"({args.slots} slots, seq_len={engine.seq_len}, {engine.device})")
    serve(engine, args.host, args.port)


if __name__ == "__main__":
    main()
