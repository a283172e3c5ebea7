"""Entry-point rules of the port against the reference: a model whose
attention the card's kernels do not take (a head dim that is not a multiple
of 8 or is past 256, more than 64 q heads a kv head) is refused at load,
before any weight is read, with the reason; every multiple of 8 up to 256
is taken (the committed HF fixtures' 16, the TinyStories models' 8 and 48);
the CLI's defaults are the reference's."""

from dataclasses import replace
from pathlib import Path

import pytest
import torch

from crabml_tpu.cli import build_parser as jax_parser
from crabml_tpu_torch.cli import build_parser as torch_parser
from crabml_tpu_torch.errors import UnsupportedError
from crabml_tpu_torch.gguf.reader import GGUFFile
from crabml_tpu_torch.gguf.writer import GGUFWriter
from crabml_tpu_torch.models.config import config_from_gguf
from crabml_tpu_torch.ops.cuda.flash_attention import check_card_attention, check_card_model

FIXDIR = Path(__file__).parent / "fixtures"
MIXTRAL = FIXDIR / "mixtral-tiny-f32.gguf"


def _cfg():
    return config_from_gguf(GGUFFile(str(MIXTRAL)).metadata)


def _hd12(tmp_path) -> str:
    """The Mixtral fixture with its heads' key length set to 12 (not a
    multiple of 8), which no kernel takes. Its tensors are the fixture's,
    never read: the refusal comes first."""
    gf = GGUFFile(str(MIXTRAL))
    w = GGUFWriter()
    for k, v in gf.metadata.as_dict().items():
        w.add_metadata(k, v, gf.metadata.value_type(k))
    w.add_metadata("llama.attention.key_length", 12)
    w.add_metadata("llama.attention.value_length", 12)
    for ti in gf.tensor_infos:
        w.add_tensor(ti.name, ti.typ, ti.shape, ti.to_numpy())
    path = str(tmp_path / "hd12.gguf")
    w.write(path)
    assert config_from_gguf(GGUFFile(path).metadata).head_dim == 12
    return path


def test_card_refuses_head_dims_its_kernels_do_not_take():
    """Head dim 12 (not a multiple of 8) and 264 (past 256) are refused on a
    card with the rule, taken on the CPU. Any count of q heads per kv head
    up to 64 is taken; a kv head count that does not divide the q heads, or
    more than 64 q heads a kv head, is refused with the reason. No card is
    needed to decide."""
    for hd in (12, 264):
        cfg = replace(_cfg(), head_dim_override=hd)
        assert cfg.head_dim == hd
        with pytest.raises(UnsupportedError, match=f"head dim {hd} .*a multiple of 8 up to 256"):
            check_card_attention(cfg, torch.device("cuda"))
        check_card_attention(cfg, torch.device("cpu"))
    for hd in (128, 64, 32):
        check_card_attention(replace(cfg, head_dim_override=hd), "cuda")
    for G in (3, 7, 64):  # any q heads per kv head up to 64 (Qwen2-7B: 7)
        check_card_attention(replace(cfg, n_heads=G * cfg.n_kv_heads, head_dim_override=128),
                             "cuda")
    with pytest.raises(UnsupportedError, match="kv heads must divide the q heads"):
        check_card_attention(replace(cfg, n_heads=3 * cfg.n_kv_heads + 1, head_dim_override=128),
                             "cuda")
    with pytest.raises(UnsupportedError, match="at most 64 q heads per kv head"):
        check_card_attention(replace(cfg, n_heads=65 * cfg.n_kv_heads, head_dim_override=128),
                             "cuda")


def test_card_takes_head_dim_256_and_refuses_96():
    """Gemma-2's head dim 256 runs on the card in bfloat16 and in float32
    (flash and every decode form; float32 decode at 256 holds K and then V in
    one tile); so do 96 (phi3) and 80 (phi2), on the 128 kernels' tiles, and
    stories15M's 48 on the 64 kernel's; 12, which no kernel takes, is
    refused with the reason, and so is a compute dtype the kernels do not
    take. No card is needed to decide. (The name is the test's from before
    96, 80, 48 and float32 at 256 were ported.)"""
    cfg = _cfg()
    hd256 = replace(cfg, head_dim_override=256)
    check_card_attention(hd256, "cuda")
    for dtype in (torch.bfloat16, torch.float32):
        check_card_attention(hd256, "cuda", dtype)
        check_card_attention(replace(cfg, head_dim_override=128), "cuda", dtype)
    check_card_attention(hd256, "cpu", torch.float32)
    for hd in (96, 80, 48):
        for dtype in (torch.bfloat16, torch.float32):
            check_card_attention(replace(cfg, head_dim_override=hd), "cuda", dtype)
    with pytest.raises(UnsupportedError, match="head dim 12 "):
        check_card_attention(replace(cfg, head_dim_override=12), "cuda", torch.bfloat16)
    with pytest.raises(UnsupportedError, match="compute dtype torch.float16"):
        check_card_attention(replace(cfg, head_dim_override=128), "cuda", torch.float16)


def test_runner_and_engines_refuse_before_reading_a_weight(tmp_path, monkeypatch):
    """On a card (faked: the device resolves to cuda) the Runner raises on a
    head-dim-12 file before load_weights is called, and both engines before
    they make a cache."""
    from crabml_tpu_torch.runtime import runner as runner_mod
    from crabml_tpu_torch.serving import engine as engine_mod
    from crabml_tpu_torch.serving.paged import PagedServingEngine

    def no_weights(*a, **k):
        raise AssertionError("a weight was read")

    path = _hd12(tmp_path)
    monkeypatch.setattr(runner_mod, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(runner_mod, "load_weights", no_weights)
    with pytest.raises(UnsupportedError, match="head dim 12"):
        runner_mod.Runner(path)
    monkeypatch.setattr(engine_mod, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(engine_mod.ServingEngine, "_reset_device_state", no_weights)
    cfg = config_from_gguf(GGUFFile(path).metadata)
    for cls in (engine_mod.ServingEngine, PagedServingEngine):
        with pytest.raises(UnsupportedError, match="head dim 12"):
            cls(weights={}, cfg=cfg)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("family", ["gemma2", "qwen3", "phi3", "mixtral"])
def test_card_takes_the_hf_fixtures_at_head_dim_16(tmp_path, monkeypatch, family, dtype):
    """The four committed HF fixtures (head dim 16, 4 q heads over 2 kv
    heads; mixtral's a mixture of experts) pass the card's check in both
    compute dtypes, the one the Runner makes before anything else; both
    engines go on past it to make their caches."""
    from crabml_tpu_torch.serving import engine as engine_mod
    from crabml_tpu_torch.serving.paged import PagedServingEngine

    class Loaded(Exception):
        pass

    def loads(*a, **k):
        raise Loaded

    path = str(FIXDIR / f"{family}-tiny-f32.gguf")
    cfg = config_from_gguf(GGUFFile(path).metadata)
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (16, 4, 2)
    check_card_model(cfg, "cuda", dtype)
    monkeypatch.setattr(engine_mod, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(engine_mod.ServingEngine, "_reset_device_state", loads)
    for cls in (engine_mod.ServingEngine, PagedServingEngine):
        with pytest.raises(Loaded):
            cls(weights={}, cfg=cfg, compute_dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 24, 48, 200])
def test_card_takes_every_multiple_of_8_up_to_256(hd, dtype):
    """stories260K's head dim 8 (2 q heads a kv head) and stories15M's 48
    (G = 1), 24 and 200 (each a class of lanes past the head dim in the flash
    kernel's 64-, 64- and 256-wide tiles) pass the card's check in both
    compute dtypes; with 65 q heads a kv head, or at 264, the same head
    layout is refused with the reason."""
    cfg = _cfg()
    for G in (1, 2, 64):
        check_card_model(replace(cfg, n_heads=G * cfg.n_kv_heads, head_dim_override=hd),
                         "cuda", dtype)
    with pytest.raises(UnsupportedError, match="at most 64 q heads per kv head"):
        check_card_model(replace(cfg, n_heads=65 * cfg.n_kv_heads, head_dim_override=hd),
                         "cuda", dtype)
    with pytest.raises(UnsupportedError, match="head dim 264"):
        check_card_model(replace(cfg, head_dim_override=264), "cuda", dtype)


def test_cli_defaults_match_the_reference():
    """-p, -n and -t default as in crabml_tpu/cli.py, so one command line
    generates the same number of tokens from the same prompt."""
    jax_args = jax_parser().parse_args(["m.gguf"])
    torch_args = torch_parser().parse_args(["m.gguf"])
    for name in ("prompt", "steps", "temperature"):
        assert getattr(torch_args, name) == getattr(jax_args, name), name
    assert torch_args.steps == 300
