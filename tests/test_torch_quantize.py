"""Weight-only int8 serving against vats_tpu (mirrors
``tests/test_quantize.py``): the same weights quantize to the same int8
bytes (transposed where the port's ``nn.Linear`` stores [out, in]), the
same leaves are selected, and a ``QuantizedModel`` decodes the same greedy
tokens as the JAX ``QuantizedModel`` (fp32 models on the CPU; weights
dequantized into bf16, the default, or fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import GenerationArgs as JGenArgs
from vats_tpu.configs import ModelArgs as JArgs
from vats_tpu.inference import quantize as jq
from vats_tpu.inference.generate import TokenGenerator as JTokenGenerator
from vats_tpu.inference.generate import generate as j_generate
from vats_tpu.inference.generate import generate_paged as j_generate_paged
from vats_tpu.models import TextLM as JTextLM
from vats_tpu_torch.configs import GenerationArgs, ModelArgs
from vats_tpu_torch.inference import (
    QuantizedModel,
    QTensor,
    TokenGenerator,
    dequantize_params,
    dequantize_tensor,
    generate,
    generate_paged,
    quantize_params,
    quantize_tensor,
    quantized_bytes,
)
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def tiny_args(**kw):
    base = dict(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                dropout=0.0, vocab_size=97, max_seq_len=48, left_window=-1,
                num_experts=2, top_k=1, dtype="float32",
                gradient_checkpointing=False, max_batch_size=8)
    base.update(kw)
    return base


def both_models(seed=3, **kw):
    args = tiny_args(**kw)
    jm = JTextLM(JArgs(**args))
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((2, 6), jnp.int32))
    cfg = ModelArgs(**args)

    def port():
        tm = TextLM(cfg, device="meta")
        tm.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, meta.unbox(params)), cfg), assign=True)
        return tm.eval()

    return jm, params, port


@pytest.mark.parametrize("shape", [(256, 128), (4, 64, 96)])
def test_quantize_tensor_byte_equal_to_jax(shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.02
    w[..., 3] = 0.0  # an all-zero channel: the scale floor
    jt = jq.quantize_tensor(jnp.asarray(w))
    tt = quantize_tensor(torch.from_numpy(w))
    assert tt.qvalue.dtype == torch.int8 and tt.scale.shape == jt.scale.shape
    np.testing.assert_array_equal(tt.qvalue.numpy(), np.asarray(jt.qvalue))
    np.testing.assert_allclose(tt.scale.numpy(), np.asarray(jt.scale), rtol=1e-6)
    # the transposed layout with channel_axis=0 gives the same bytes
    t0 = quantize_tensor(torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, 0, -1))), 0)
    np.testing.assert_array_equal(np.swapaxes(t0.qvalue.numpy(), 0, -1),
                                  np.asarray(jt.qvalue))
    # dequantization is a product in the compute dtype
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        np.testing.assert_array_equal(dequantize_tensor(tt, tdt).float().numpy(),
                                      np.asarray(jq.dequantize_tensor(jt, jdt), np.float32))


@pytest.mark.parametrize("min_size", [1, 4096, 1 << 16])
def test_quantize_params_selects_the_same_leaves_with_the_same_bytes(min_size):
    jm, params, port = both_models()
    jqp = jq.quantize_params(params, min_size=min_size)
    tm = port()
    tqp = quantize_params(tm, min_size=min_size)
    cfg = tm.cfg
    is_q = lambda x: isinstance(x, jq.QTensor)  # noqa: E731
    # a marker tree (1 where JAX quantized a leaf) and the int8 values, both
    # carried into the port's names and layouts by the weight converter
    marks = jax.tree_util.tree_map(
        lambda x: np.ones(x.shape, np.float32) if is_q(x) else np.zeros(np.shape(x)),
        jqp, is_leaf=is_q)
    qvals = jax.tree_util.tree_map(
        lambda x: np.asarray(x.qvalue, np.float32) if is_q(x) else np.asarray(x),
        jqp, is_leaf=is_q)
    marks = params_from_jax(meta.unbox(marks), cfg)
    qvals = params_from_jax(meta.unbox(qvals), cfg)
    chosen = {k for k, v in marks.items() if bool(v.any())}
    assert chosen == {k for k, v in tqp.items() if isinstance(v, QTensor)}
    assert chosen or min_size > 1 << 15
    for name in chosen:
        np.testing.assert_array_equal(tqp[name].qvalue.float().numpy(), qvals[name].numpy())
    assert quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    if chosen:
        assert quantized_bytes(tqp) < 0.3 * quantized_bytes(
            {k: v.detach() for k, v in tm.named_parameters()})


def test_dequantize_params_forward_close_to_fp32():
    """Every weight int8 (min_size 1) and dequantized into fp32: logits keep
    a cosine > 0.999 with the fp32 forward, as in the JAX test."""
    _, _, port = both_models(seed=1)
    tm = port()
    ids = torch.ones((1, 8), dtype=torch.int32)
    with torch.no_grad():
        ref, _, _ = tm(ids)
        deq = dequantize_params(quantize_params(tm, min_size=1), torch.float32)
        assert set(deq) == {k for k, _ in tm.named_parameters()}
        tq = port()
        tq.load_state_dict(deq)
        got, _, _ = tq(ids)
    cos = torch.nn.functional.cosine_similarity(ref.reshape(1, -1), got.reshape(1, -1))
    assert float(cos) > 0.999


def test_quantized_model_keeps_only_int8_weights_resident():
    _, _, port = both_models()
    qm = QuantizedModel(port(), min_size=1)
    names = {k for k, v in qm.qparams.items() if isinstance(v, QTensor)}
    live = {k for k, _ in qm.model.named_parameters()}
    assert names and not names & live  # float copies released
    seen = []
    layer0 = qm.model.layers[0].attn_block.attn.w_qkv
    qm.model.layers[1].register_forward_pre_hook(
        lambda m, a: seen.append(layer0.weight is None))
    logits, _, _ = qm(torch.ones((1, 4), dtype=torch.int32))
    assert seen == [True]  # layer 0's weights dropped before layer 1 starts
    assert not names & {k for k, _ in qm.model.named_parameters()}
    assert logits.shape == (1, 4, 97) and bool(torch.isfinite(logits).all())
    assert qm.device == torch.device("cpu")


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_quantized_greedy_decode_equals_jax(compute):
    """QuantizedModel greedy tokens against the JAX QuantizedModel's:
    bf16 dequant through generate_paged (min_size 1: every matrix int8),
    fp32 dequant through the dense generate (test_quantize.py:94)."""
    jm, params, port = both_models()
    prompt = np.random.RandomState(2).randint(1, 97, (2, 6)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if compute == "bfloat16" else (
        jnp.float32, torch.float32)
    jqm = jq.QuantizedModel(jm, compute_dtype=jdt)
    jqp = jq.quantize_params(params, min_size=1)
    tqm = QuantizedModel(port(), compute_dtype=tdt, min_size=1)
    common = dict(max_new_tokens=6, do_sample=False, temperature=0.0, pad_token_id=0,
                  total_len=16)
    j_fn, t_fn = ((j_generate_paged, generate_paged) if compute == "bfloat16"
                  else (j_generate, generate))
    jt, jl = j_fn(jqm, jqp, jnp.asarray(prompt), None, jax.random.PRNGKey(4), **common)
    tt, tl = t_fn(tqm, torch.from_numpy(prompt), None, None, **common)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


class Tok:
    pad_token_id = 0
    eos_token_id = None

    def encode(self, text):
        return [hash(w) % 90 + 1 for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def test_token_generator_int8_weights_and_kv_equal_jax():
    args = tiny_args(num_experts=1, max_seq_len=64)
    jgen = JTokenGenerator(JArgs(**args), seed=0, use_paged=True, quantize="int8",
                           kv_quant="int8")
    cfg = ModelArgs(**args)
    # the JAX generator quantized its params already; carry the float ones
    raw = JTextLM(JArgs(**args)).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(raw))
    tgen = TokenGenerator(cfg, params=params_from_jax(pnp, cfg), use_paged=True,
                          quantize="int8", kv_quant="int8", device="cpu")
    assert isinstance(tgen.model, QuantizedModel)
    kw = dict(max_new_tokens=8, temperature=0.0, do_sample=False, top_k=None,
              top_p=None, repetition_penalty=None)
    prompt = "Once upon a time, in a land far away"
    out_t = tgen.generate_tokens(prompt, GenerationArgs(**kw), Tok())
    assert out_t == jgen.generate_tokens(prompt, JGenArgs(**kw), Tok())
    assert len(out_t.split()) == 8
    with pytest.raises(ValueError):
        TokenGenerator(cfg, quantize="int4", device="cpu")
    with pytest.raises(ValueError):
        TokenGenerator(cfg, kv_quant="int8", device="cpu")  # needs use_paged
