"""The latent serving cell's own pieces: the reference's weights against the
port's state dict, the work counts, the two readers, the traffic's sizes,
the configuration file against the published config, and a tiny run of
the driver on the CPU."""

import copy
import json
import math
import os
import time
import types

import pytest
import torch

from benchmark import harness, work_mla
from benchmark import traffic as tr
from benchmark.drivers import serve_mla as sm
from benchmark.reference.deepseek_v2 import param_specs, softmax_scale

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "deepseek_v2_lite.json")
MIX = _json("traffic", "reasoning_256.json")
CATALOG_CONFIG = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 128, "vocab_size": 102400}


def test_configuration_states_the_published_model():
    c, m = CONFIG, CONFIG["model"]
    assert {k: c[k] for k in CATALOG_CONFIG} == CATALOG_CONFIG and c["reduced"] == []
    assert (m["d_model"], m["num_heads"], m["num_layers"], m["vocab_size"]) == (
        c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"], c["vocab_size"])
    assert (m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
            m["v_head_dim"]) == (c["kv_lora_rank"], c["qk_nope_head_dim"],
                                 c["qk_rope_head_dim"], c["v_head_dim"])
    assert (m["num_experts"], m["top_k"], m["d_ffn"], m["n_shared_experts"]) == (
        c["n_routed_experts"], c["num_experts_per_tok"], c["moe_intermediate_size"],
        c["n_shared_experts"])
    assert (m["first_k_dense_replace"], m["dense_d_ffn"], m["norm_topk_prob"],
            m["routed_scaling_factor"]) == (c["first_k_dense_replace"], c["intermediate_size"],
                                            c["norm_topk_prob"], c["routed_scaling_factor"])
    y = c["rope_scaling"]
    assert (m["yarn_factor"], m["yarn_original_max_position"], m["yarn_beta_fast"],
            m["yarn_beta_slow"], m["yarn_mscale"], m["yarn_mscale_all_dim"]) == (
        y["factor"], y["original_max_position_embeddings"], y["beta_fast"], y["beta_slow"],
        y["mscale"], y["mscale_all_dim"])
    assert (m["rope_base"], m["rms_norm_eps"], m["tie_weights"]) == (
        c["rope_theta"], c["rms_norm_eps"], c["tie_word_embeddings"])
    assert c["q_lora_rank"] is None and not c["attention_bias"]
    assert softmax_scale(m) == pytest.approx(0.114721, abs=1e-6)


def test_param_specs_are_the_ports_state_dict_at_full_size():
    from vats_tpu_torch.configs.nlp import LatentModelArgs
    from vats_tpu_torch.models.text_lm import TextLM

    m = CONFIG["model"]
    model = TextLM(LatentModelArgs(**m), device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _, _ in param_specs(m)}
    assert got == want
    biases = 26 * 64  # the port's zero router biases, which the published gate lacks
    assert sum(math.prod(s) for s in got.values()) == CONFIG["published"]["params"] + biases


def test_work_counts():
    m = CONFIG["model"]
    dense, expert, head = work_mla.mla_params(m)
    assert dense + 26 * 6 * expert + head == CONFIG["published"][
        "active_params_per_token"] + 26 * 64
    assert work_mla.weight_bytes(m, 64) - work_mla.weight_bytes(m, 0) == pytest.approx(
        28.79e9, rel=1e-3)
    assert work_mla.latent_bytes_per_token(m) == CONFIG["published"][
        "latent_kv_bytes_per_token_bf16"] == 31104
    nb, nf = work_mla.mla_decode_cost(m, [100, 28])
    assert nb == 128 * 1152 + 2 * 16 * (576 + 512) * 2 + 2 * 4
    assert nf == 2 * 16 * 128 * (576 + 512)
    assert work_mla.prefill_attn_flops(m, 10) == 2 * 16 * 10 * (192 + 128)


@pytest.mark.parametrize("name,record,want", [
    ("mla_decode_roofline",
     {"trace": {"by_name": {"mla_decode_kernel": 0.004, "other": 1.0},
                "counters": {"mla_decode_least_s": 0.002}}}, 50.0),
    ("mla_attn_share.decode",
     {"decode_probe": {"device_s": {"serve.dispatch/graph.run/attn.mla": 0.25,
                                    "serve.dispatch/graph.run/attn.mla/mla.decode": 0.15,
                                    "serve.dispatch/graph.run/moe.experts": 0.6,
                                    "serve.admit/serve.prefill/graph.run/attn.mla": 5.0}}}, 40.0),
    ("mla_decode_roofline", {"trace": {"by_name": {}, "counters": {}}}, None),
    ("mla_attn_share.decode", {}, None),
])
def test_readers(name, record, want):
    got = harness.load_reader(name)(record)
    assert got == (None if want is None else pytest.approx(want))


def test_traffic_sizes():
    """Every round of 256 the same quantiles: prompts of median 1536 in
    [512, 6144], answers of median 2048 in [512, 6144]; every request fits
    the 12,288 context."""
    p, o = tr.quantile_sizes(MIX["prompt"], 256), tr.quantile_sizes(MIX["output"], 256)
    assert sorted(p)[127] < 1536 < sorted(p)[128] and sorted(o)[127] < 2048 < sorted(o)[128]
    assert (p.min(), p.max(), o.min(), o.max()) == (512, 6144, 512, 6144)
    t = tr.serve_traffic(MIX, 2**31 + 11, vocab=CONFIG["model"]["vocab_size"])
    assert all(len(r.prompt) + r.max_new_tokens <= CONFIG["engine"]["max_context"]
               for r in t.requests)
    assert sum(r.greedy for r in t.requests[:256]) == 64
    assert sm.serve_hybrid.buckets_for(MIX["prompt"]["min"], MIX["prompt"]["max"],
                                       CONFIG["engine"]["prompt_buckets"]) == [1024, 2048,
                                                                               4096, 6144]


def _tiny_ctx(seed=987654321013, control=None, trace=False):
    cfg = copy.deepcopy(CONFIG)
    cfg["model"].update(d_model=64, num_heads=4, query_groups=4, kv_lora_rank=32,
                        qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, d_ffn=32,
                        dense_d_ffn=96, num_layers=3, num_experts=8, top_k=2,
                        n_shared_experts=1, yarn_original_max_position=32, vocab_size=97,
                        max_seq_len=512, dtype="float32", param_dtype="float32")
    cfg["engine"] = dict(max_batch=4, max_context=256, page_size=128, total_pages=9,
                         prefix_caching=False, decode_block_steps=4, per_request_sampling=True,
                         sampling_kmax=64, prompt_buckets=[32, 64, 128], max_prefill_tokens=128)
    mix = dict(MIX, clients=4, pool=64, warmup_s=0.3,
               prompt=dict(MIX["prompt"], median=40, min=20, max=120),
               output=dict(MIX["output"], median=24, min=17, max=60))
    return types.SimpleNamespace(
        config=cfg, mix=mix, limits=_json("limits", "v2lite.reasoning_256.json"), seed=seed,
        seconds=1.5, trace=trace, device=torch.device("cpu"), chips=1, rec=harness.Recorder(),
        process_start=time.time(), control=control, rate=None)


def test_a_tiny_run_is_correct_and_its_control_is_not_closer():
    """The driver end to end at a tiny fp32 size: correct, the decode
    through K9's plain version (counted on the CPU), the work counted; the
    fp8 control's gaps lie above the program's."""
    torch.set_num_threads(2)
    out = sm.run(_tiny_ctx(control=True))
    assert harness.within(out["checks"]), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    c = out["record"]["counters"]
    assert c["decode_rows"] > 0 and c["forward_least_s"] > 0 and c["mla_decode_least_s"] > 0
    assert c["k9_plain_calls"] == 3 * c["decode_forwards"] and c["k9_launches"] == 0
    info = out["info"]
    assert info["control_mean_logit_gap"] > out["checks"]["mean_logit_gap"]["value"]


@pytest.mark.cuda
def test_the_cells_control_fails_on_the_card():
    """On the card at the cell's own size: the program's gaps lie within the
    cell's limits and the control's (the reference held in fp8 in the
    program's place) exceed one of them: ``python -m pytest --noconftest -m
    cuda benchmark/tests/test_bench_mla.py`` prints the readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's own size)")
    from benchmark.control import serve_readings
    from benchmark.run import make_ctx

    workload, seed = "v2lite.reasoning_256", 2**31 + 2027
    _, ctx = make_ctx(workload, seed, 20.0)
    row = serve_readings(workload, seed, 20.0)
    print(json.dumps(row))
    for name in ("mean_logit_gap", "sampled_set_gap"):
        assert row[f"program_{name}"] <= ctx.limits[name], row
    assert any(row[f"control_{k}"] > v for k, v in ctx.limits.items()), row
