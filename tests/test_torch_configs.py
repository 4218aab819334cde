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
    banned = re.compile(r"^(jax|flax|jaxlib|optax|orbax|vats_tpu)(\.|$)")
    for path in _port_sources():
        src = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|jaxlib|optax|orbax)\b", src,
                             re.M), path
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


def test_port_never_names_the_jax_packages_native_loader():
    """The port builds its own shard loader from its own C source; no port
    file reads or loads the JAX package's (neither its source nor its
    library)."""
    pkg = REPO / "vats_tpu_torch"
    files = [p for p in pkg.rglob("*") if p.is_file() and "_build" not in p.parts
             and "__pycache__" not in p.parts] + [REPO / "chip_smoke.py"]
    assert any(p.suffix == ".c" for p in files)
    for path in files:
        src = path.read_text()
        for name in ("vats_tpu/data/native", "libvats_shard"):
            assert name not in src, f"{path} names {name}"


VISION_TIERS = [("vit2d", "vit2d_xsmall"), ("vit2d", "vit2d_small"), ("vit2d", "vit2d_medium"),
                ("vit3d", "vit3d_xsmall"), ("vit3d", "vit3d_large"),
                ("vit3d", "vit3d_tiny_test")]


@pytest.mark.parametrize("module,tier", VISION_TIERS)
def test_vision_configs_match(module, tier):
    import importlib

    jmod = importlib.import_module(f"vats_tpu.configs.{module}")
    tmod = importlib.import_module(f"vats_tpu_torch.configs.{module}")
    cls = "ViT2DArgs" if module == "vit2d" else "ViT3DArgs"
    assert _fields(getattr(tmod, cls)) == _fields(getattr(jmod, cls))
    j, t = getattr(jmod, tier)(), getattr(tmod, tier)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.grid_size) == (j.head_dim, j.grid_size)
    for bad in (dict(num_heads=7), dict(query_groups=5)):
        with pytest.raises(ValueError) as ej:
            getattr(jmod, tier)(**bad)
        with pytest.raises(ValueError) as et:
            getattr(tmod, tier)(**bad)
        assert str(et.value) == str(ej.value)


def test_vision_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    from vats_tpu_torch.configs import vit2d_xsmall, vit3d_tiny_test
    from vats_tpu_torch.models import ImageEncoder, VideoTransformer

    for model, cfg in ((ImageEncoder, vit2d_xsmall()), (VideoTransformer, vit3d_tiny_test())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model(cfg)
        assert model(cfg, device="cpu").device.type == "cpu"


def test_vision_modules_are_ported():
    """The vision slice's modules exist in the port (each is held to the
    import rule above with the rest of the package)."""
    for rel in ("configs/vit2d.py", "configs/vit3d.py", "nn/activations.py", "nn/rope.py",
                "nn/attention.py", "models/vit2d.py", "models/vit3d.py", "utils/convert.py",
                "data/augmentations.py", "data/pixel_augs.py", "data/vision_data.py",
                "data/video_decode.py", "train/vision.py"):
        assert (REPO / "vats_tpu_torch" / rel) in _port_sources(), rel


def test_parallel_modules_are_ported():
    """The parallel slice's modules exist in the port (held to the import
    rule above), and the rank bodies its tests spawn import no JAX either
    (a spawned child does not run tests/conftest.py)."""
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                "parallel/multihost.py", "parallel/sharded.py", "parallel/layout.py",
                "parallel/pipeline.py", "ops/ring_attention.py", "ops/ulysses.py"):
        assert (REPO / "vats_tpu_torch" / rel) in _port_sources(), rel
    src = (REPO / "tests" / "torch_parallel_ranks.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|vats_tpu)\b", src, re.M)


def test_latent_args_are_port_only_and_leave_model_args_alone():
    """``LatentModelArgs`` (MLA, DeepSeek-V2) has no counterpart in the JAX
    package; it extends ``ModelArgs`` without changing a field of it, so
    ``ModelArgs`` still matches the JAX package's (above), and its modules
    are held to the import rule with the rest of the port."""
    assert not hasattr(jcfg, "LatentModelArgs")
    base = {f.name: (f.default, f.default_factory) for f in dataclasses.fields(tcfg.ModelArgs)}
    latent = {f.name: (f.default, f.default_factory)
              for f in dataclasses.fields(tcfg.LatentModelArgs)}
    assert {k: latent[k] for k in base} == base
    assert _fields(tcfg.ModelArgs) == _fields(jcfg.ModelArgs)
    for rel in ("configs/nlp.py", "nn/mla.py", "ops/mla_decode.py"):
        assert (REPO / "vats_tpu_torch" / rel) in _port_sources(), rel
