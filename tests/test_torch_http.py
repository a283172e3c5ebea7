"""The port's HTTP daemon on 127.0.0.1 with `--device cpu`: completions, SSE
streaming, /health, /metrics, /v1/models, and the chat endpoint's 501."""

import http.client
import json
import threading

import pytest

from crabml_tpu_torch.serving import http as serving_http
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf


@pytest.fixture(scope="module", params=["paged", "dense"])
def daemon(request, tmp_path_factory):
    path = build_synth_gguf(str(tmp_path_factory.mktemp("gguf") / "tiny.gguf"), "tiny", seed=2)
    argv = [path, "--device", "cpu", "--dtype", "f32", "--host", "127.0.0.1", "--port", "0",
            "--slots", "2", "--seq-len", "256"]
    if request.param == "paged":
        argv += ["--paged", "--pages", "8"]
    engine, args = serving_http.engine_from_args(argv)
    server = serving_http.make_server(engine, args.host, args.port)
    thread = threading.Thread(target=serving_http.serve, args=(engine,),
                              kwargs={"server": server}, daemon=True)
    thread.start()
    yield engine, server.server_address[1]
    server.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _call(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = None if payload is None else json.dumps(payload)
    conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


def test_completions_and_generate(daemon):
    engine, port = daemon
    n_prompt = len(engine.tokenizer.encode("hello there", bos=True))
    bias = {"2": -1e4}  # random weights emit EOS now and then
    status, _, data = _call(port, "POST", "/v1/completions",
                            {"prompt": "hello there", "max_tokens": 6, "logit_bias": bias})
    out = json.loads(data)
    assert status == 200 and out["object"] == "text_completion"
    assert out["usage"] == {"prompt_tokens": n_prompt, "completion_tokens": 6,
                            "total_tokens": n_prompt + 6}
    assert out["choices"][0]["finish_reason"] == "length"
    # the same request again, through /generate, with logprobs and two choices
    status, _, data = _call(port, "POST", "/generate",
                            {"prompt": "hello there", "max_tokens": 6, "logprobs": 2, "n": 2,
                             "logit_bias": bias})
    again = json.loads(data)
    assert status == 200 and len(again["choices"]) == 2
    assert again["choices"][0]["text"] == again["choices"][1]["text"] == out["choices"][0]["text"]
    lp = again["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["top_logprobs"]) == 6
    assert again["usage"]["completion_tokens"] == 12


def test_sse_stream_ends_in_done(daemon):
    engine, port = daemon
    status, ctype, data = _call(port, "POST", "/v1/completions",
                                {"prompt": "stream me", "max_tokens": 5, "stream": True,
                                 "logit_bias": {"2": -1e4},
                                 "stream_options": {"include_usage": True}})
    assert status == 200 and ctype == "text/event-stream"
    events = [ln[len("data: "):] for ln in data.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    assert parsed[-1]["usage"]["completion_tokens"] == 5
    assert all("text" in e for e in parsed[:-1]) and len(parsed) >= 2


def test_health_metrics_models(daemon):
    engine, port = daemon
    _call(port, "POST", "/v1/completions", {"prompt": "warm", "max_tokens": 2})
    status, _, data = _call(port, "GET", "/health")
    health = json.loads(data)
    assert status == 200 and health["status"] == "ok" and health["slots_total"] == 2
    assert health["tokens_generated"] >= 1
    assert ("pages_free" in health) == hasattr(engine, "pages_free")
    status, ctype, data = _call(port, "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    assert "crabml_requests_completed_total" in data and "crabml_ttft_seconds_count" in data
    status, _, data = _call(port, "GET", "/v1/models")
    assert status == 200 and json.loads(data)["data"][0]["id"] == engine.cfg.model_name
    assert _call(port, "GET", "/nope")[0] == 404


def test_chat_answers_501_and_bad_requests_400(daemon):
    _, port = daemon
    status, _, data = _call(port, "POST", "/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "hi"}]})
    assert status == 501 and "not ported" in json.loads(data)["error"]["message"]
    assert _call(port, "POST", "/v1/completions", {"prompt": "x", "n": 99})[0] == 400
    assert _call(port, "POST", "/v1/completions", {"prompt": "x", "stop": [1]})[0] == 400
    status, _, data = _call(port, "POST", "/tokenize", {"content": "hello"})
    toks = json.loads(data)["tokens"]
    status, _, data = _call(port, "POST", "/detokenize", {"tokens": toks})
    assert status == 200 and json.loads(data)["content"].strip() == "hello"


def test_concurrent_posts_all_complete(daemon):
    """More clients than slots, all at once: handler threads only enqueue, the
    engine thread batches them, every request is answered and counted once."""
    engine, port = daemon
    before = engine.requests_submitted
    results = []

    def client(i):
        for j in range(2):
            results.append(_call(port, "POST", "/v1/completions",
                                 {"prompt": f"client {i} request {j}", "max_tokens": 3,
                                  "logit_bias": {"2": -1e4}}))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 12 and all(status == 200 for status, _, _ in results)
    assert all(json.loads(d)["usage"]["completion_tokens"] == 3 for _, _, d in results)
    assert engine.requests_submitted == before + 12
    assert engine.requests_completed == engine.requests_submitted
    assert not any(engine.slots)
