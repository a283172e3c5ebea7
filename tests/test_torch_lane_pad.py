"""The JAX package's kv_lane_pad (Runner(kv_lane_pad=True), the engines'
argument, the CLI's and the daemon's --kv-lane-pad) in the port, on
`tiny-phi2` (head dim 80), where tests/test_lane_pad.py's 260k fixture is
not in the repo.

The JAX package stores a head dim that is not a multiple of 128 at 128 lanes
because its decode kernels take nothing else. The port's attention kernels
take head dims 80 and 96 as they are, so the flag is accepted wherever the
JAX package takes it and changes nothing: the cache keeps the model's head
dim, the attention runs at it, and the tokens are those without the flag."""

import pytest
import torch

from crabml_tpu_torch import cli
from crabml_tpu_torch.models import forward as fwd
from crabml_tpu_torch.models.forward import forward
from crabml_tpu_torch.runtime.runner import Runner
from crabml_tpu_torch.serving import PagedServingEngine, ServingEngine
from crabml_tpu_torch.serving import http
from crabml_tpu_torch.serving import paged as paged_mod
from crabml_tpu_torch.tools.synth_gguf import build_synth_gguf
# one_torch_thread (autouse) is a fixture, used by import
from torch_families_common import one_torch_thread

PROMPT = "Lily is a cat"


@pytest.fixture(scope="module")
def phi2(tmp_path_factory):
    """The tiny-phi2 Q4_K file."""
    d = tmp_path_factory.mktemp("lane_pad")
    return build_synth_gguf(str(d / "tiny-phi2.gguf"), "tiny-phi2", seed=3)


def _runner(path, **kw):
    return Runner(path, seq_len=256, compute_dtype=torch.float32, device="cpu", **kw)


def _gen(runner, steps=16):
    runner.reset()
    return "".join(runner.prefill_and_generate(PROMPT, steps))


def test_runner_takes_the_flag_and_keeps_the_head_dim(phi2):
    """Runner(kv_lane_pad=True): the cache is the model's 80 lanes wide, as
    without the flag, and its 16 greedy tokens are the unpadded Runner's."""
    plain, flagged = _runner(phi2), _runner(phi2, kv_lane_pad=True)
    assert flagged.cfg.head_dim == 80
    assert plain.cache.k.shape == flagged.cache.k.shape
    assert flagged.cache.k.shape[-1] == 80
    assert _gen(flagged) == _gen(plain)


@pytest.mark.parametrize("kv_dtype", [None, torch.int8], ids=["f32", "int8"])
def test_serving_engines_take_the_flag(phi2, kv_dtype):
    """ServingEngine and PagedServingEngine(kv_lane_pad=True) build, keep
    the cache or pool at 80 lanes in the compute dtype or int8, and give the
    engines' greedy text without the flag; the paged engine returns its
    pages."""
    runner = _runner(phi2)
    prompts = [PROMPT, "w5 w6 w7 " * 4]
    for engine in (ServingEngine, PagedServingEngine):
        kw = dict(n_slots=2, seq_len=256, kv_dtype=kv_dtype)
        if engine is PagedServingEngine:
            kw["n_pages"] = 8
        want = engine(runner, **kw).generate(prompts, max_tokens=10)
        eng = engine(runner, kv_lane_pad=True, **kw)
        assert eng.cache.k.shape[-1] == 80
        assert eng.cache.k.dtype == (kv_dtype or torch.float32)
        free = eng.pages_free() if engine is PagedServingEngine else None
        assert eng.generate(prompts, max_tokens=10) == want
        if free is not None:
            assert eng.pages_free() == free


def test_cli_and_daemon_parse_the_flag(phi2, capsys):
    """--kv-lane-pad parses on the CLI, which runs the file on the CPU, and
    on the daemon, whose paged engine keeps an 80-lane pool."""
    args = cli.build_parser().parse_args([phi2, "--kv-lane-pad"])
    assert args.kv_lane_pad
    assert cli.main([phi2, "-p", PROMPT, "-n", "4", "--device", "cpu", "--kv-lane-pad"]) == 0
    assert PROMPT in capsys.readouterr().out
    engine, args = http.engine_from_args([phi2, "--device", "cpu", "--dtype", "f32",
                                          "--paged", "--pages", "8", "--slots", "2",
                                          "--seq-len", "256", "--kv-lane-pad"])
    assert args.kv_lane_pad and isinstance(engine, PagedServingEngine)
    assert engine.cache.k.shape[-1] == 80


@pytest.mark.parametrize("lane_pad", [True, False], ids=["flag", "no_flag"])
def test_head_dim_80_runs_the_native_forms(phi2, monkeypatch, lane_pad):
    """With the flag or without, flash and the four decode-attention forms
    (the dense prompt, chunk and step; the paged engine's 131-token prompt,
    its 3-token one through the table, and its ticks) see head dim 80, and
    the scale is that of head dim 80."""
    seen, scales = [], []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(q, kc, vc, *a, **kw):
            seen.append((name, q.shape[-1], kc.shape[-1]))
            if name == "decode_attention_fused":
                scales.append(a[2])  # (layer, pos, scale, ...)
            return real(q, kc, vc, *a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("flash_attention", "decode_attention", "decode_attention_fused"):
        spy(fwd, name)
    for name in ("flash_attention", "paged_decode_attention", "paged_decode_attention_fused"):
        spy(paged_mod, name)
    r = _runner(phi2, kv_lane_pad=lane_pad)
    forward(r.weights, r.cache, torch.arange(3, 23)[None], torch.tensor([0]), r.cfg)
    forward(r.weights, r.cache, torch.arange(3, 6)[None], torch.tensor([20]), r.cfg)
    forward(r.weights, r.cache, torch.tensor([[7]]), torch.tensor([23]), r.cfg)
    PagedServingEngine(r, n_slots=2, n_pages=8, seq_len=256, kv_lane_pad=lane_pad).generate(
        ["w5 " * 130, "w6 w7"], max_tokens=3)
    assert {n for n, _, _ in seen} == {"flash_attention", "decode_attention",
                                        "decode_attention_fused", "paged_decode_attention",
                                        "paged_decode_attention_fused"}
    assert {(q, kv) for _, q, kv in seen} == {(80, 80)}
    assert set(scales) == {80 ** -0.5}
