"""The port's configs, package hygiene and device defaults.

``vats_tpu_torch`` keeps its own copy of ``vats_tpu/configs/nlp.py``; these
tests hold the copy to the original field by field."""

import ast
import dataclasses
import pathlib
import re

import pytest
import torch

import vats_tpu.configs.nlp as jcfg
import vats_tpu_torch.configs.nlp as tcfg

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _fields(cls):
    return [
        (f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)
    ]


@pytest.mark.parametrize("name", ["ModelArgs", "GenerationArgs", "TrainingArgs"])
def test_dataclass_fields_and_defaults_match(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


@pytest.mark.parametrize("tier", ["xsmall", "small", "medium", "large", "xlarge"])
def test_size_tiers_match(tier):
    j = jcfg.NLP_TIERS[tier](dropout=0.0)
    t = tcfg.NLP_TIERS[tier](dropout=0.0)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.head_dim == j.head_dim


@pytest.mark.parametrize(
    "bad",
    [
        dict(d_model=250),
        dict(query_groups=3),
        dict(d_ffn=0),
        dict(num_experts=1, top_k=2),
        dict(use_causal=False),
        dict(right_window=1),
        dict(left_window=0),
    ],
)
def test_validation_errors_match(bad):
    with pytest.raises(ValueError) as ej:
        jcfg.ModelArgs(**bad)
    with pytest.raises(ValueError) as et:
        tcfg.ModelArgs(**bad)
    assert str(et.value) == str(ej.value)


def _port_sources():
    files = sorted((REPO / "vats_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_never_imports_jax_flax_or_the_jax_package():
    assert len(_port_sources()) > 10
    banned = re.compile(r"^(jax|flax|jaxlib|vats_tpu)(\.|$)")
    for path in _port_sources():
        src = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", src, re.M), path
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert not banned.match(mod), f"{path}: imports {mod}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    from vats_tpu_torch.inference import TokenGenerator
    from vats_tpu_torch.models import TextLM

    cfg = tcfg.nlp_xsmall(dropout=0.0, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenGenerator(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextLM(cfg)
    gen = TokenGenerator(cfg, device="cpu")
    assert gen.model.device.type == "cpu"
