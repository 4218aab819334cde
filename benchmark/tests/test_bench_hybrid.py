"""The hybrid serving cell's own pieces: the reference's weights against the
port's state dict, the work counts, the three readers, the traffic's
sizes, the configuration file against the published config, and a tiny
run of the driver on the CPU."""

import copy
import json
import math
import os
import time
import types

import pytest
import torch

from benchmark import harness
from benchmark import traffic as tr
from benchmark.drivers import serve_hybrid as sh
from benchmark.reference.mellum import FULL, SLIDING, param_specs

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "mellum2_12b_a2.5b.json")
MIX = _json("traffic", "code_chat_8k.json")


def test_configuration_states_the_published_model():
    m, c = CONFIG["model"], CONFIG
    assert (m["d_model"], m["num_heads"], m["query_groups"], m["head_dim"]) == (
        c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"])
    assert (m["num_layers"], m["num_experts"], m["top_k"], m["d_ffn"]) == (
        c["num_hidden_layers"], c["num_experts"], c["num_experts_per_tok"],
        c["moe_intermediate_size"])
    assert m["layer_types"] == c["layer_types"] and m["left_window"] == c["sliding_window"] - 1
    assert (m["vocab_size"], m["rms_norm_eps"], m["tie_weights"]) == (
        c["vocab_size"], c["rms_norm_eps"], c["tie_word_embeddings"])
    assert set(c["mlp_layer_types"]) == {"sparse"} and not c["attention_bias"]
    yarn = c["rope_parameters"]["full_attention"]
    assert (m["yarn_factor"], m["yarn_original_max_position"], m["yarn_beta_fast"],
            m["yarn_beta_slow"], m["yarn_attention_factor"]) == (
        yarn["factor"], yarn["original_max_position_embeddings"], yarn["beta_fast"],
        yarn["beta_slow"], yarn["attention_factor"])
    assert m["rope_base"] == yarn["rope_theta"] == c["rope_parameters"]["sliding_attention"][
        "rope_theta"]
    assert c["reduced"] == []


def test_param_specs_are_the_ports_state_dict_at_full_size():
    from vats_tpu_torch.configs.nlp import HybridModelArgs
    from vats_tpu_torch.models.text_lm import TextLM

    m = CONFIG["model"]
    model = TextLM(HybridModelArgs(**m), device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _, _ in param_specs(m)}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == CONFIG["published"]["params"]


def test_work_counts():
    m = CONFIG["model"]
    dense, expert, head = sh.hybrid_params(m)
    assert dense + m["num_layers"] * m["top_k"] * expert + head == CONFIG["published"][
        "active_params_per_token"]
    assert sh.weight_bytes(m, 64) - sh.weight_bytes(m, 0) == pytest.approx(22.196e9, rel=1e-4)
    assert sh.kv_bytes_per_token_layer(m) * m["num_layers"] == CONFIG["published"][
        "kv_bytes_per_token_bf16"]
    windows = sh.layer_windows(m)
    assert windows[:4] == [1023, 1023, 1023, -1] and windows.count(-1) == 7
    assert [sh.attended(w, 3000) for w in windows[:4]] == [1023, 1023, 1023, 3000]
    assert [sh.attended(w, 500) for w in windows[:4]] == [500] * 4
    # the pairs a causal prefill attends, counted one by one
    small = dict(m, layer_types=[SLIDING, FULL], left_window=3)
    for n in (1, 3, 4, 5, 17):
        brute = sum(min(q + 1, 4) for q in range(n)) + n * (n + 1) // 2
        assert sh.prefill_pairs(small, n) == brute


@pytest.mark.parametrize("name,record,want", [
    ("kv_window_dead_share", {"counters": {"kv_dead_share_sum": 1.5, "kv_share_steps": 3}}, 50.0),
    ("window_attn_share.decode",
     {"decode_probe": {"device_s": {"serve.dispatch/graph.run/attn.window": 0.3,
                             "serve.dispatch/graph.run/attn.full": 0.1,
                             "serve.dispatch/graph.run/moe.experts": 0.6,
                             "serve.admit/serve.prefill/graph.run/attn.window": 5.0}}}, 30.0),
    ("full_attn_share.decode",
     {"decode_probe": {"device_s": {"serve.dispatch/graph.run/attn.window": 0.3,
                             "serve.dispatch/graph.run/attn.full": 0.1,
                             "serve.dispatch/graph.run/moe.experts": 0.6}}}, 10.0),
])
def test_readers(name, record, want):
    assert harness.load_reader(name)(record) == pytest.approx(want)


def test_traffic_sizes():
    """Every round of 64 the same quantiles: prompts of median 2048 in
    [1024, 6144], answers of median 512 in [192, 1920]; every row decodes
    past the 1,024-token window and ends inside the 8,192 context."""
    p, o = tr.quantile_sizes(MIX["prompt"], 64), tr.quantile_sizes(MIX["output"], 64)
    assert sorted(p)[31] < 2048 < sorted(p)[32] and sorted(o)[31] < 512 < sorted(o)[32]
    assert (p.min(), p.max(), o.min(), o.max()) == (1024, 6144, 192, 1920)
    t = tr.serve_traffic(MIX, 2**31 + 7, vocab=CONFIG["model"]["vocab_size"])
    assert all(len(r.prompt) >= 1024 and len(r.prompt) + r.max_new_tokens
               < CONFIG["engine"]["max_context"] for r in t.requests[:256])
    assert sum(r.greedy for r in t.requests[:64]) == 16
    eng = CONFIG["engine"]
    assert sh.buckets_for(MIX["prompt"]["min"], MIX["prompt"]["max"],
                          eng["prompt_buckets"]) == [2048, 4096, 6144]


def _tiny_ctx(seed=987654321012, control=None):
    cfg = copy.deepcopy(CONFIG)
    cfg["model"].update(d_model=64, num_heads=4, query_groups=2, head_dim=24, d_ffn=32,
                        num_layers=4, num_experts=8, top_k=4, left_window=15,
                        layer_types=cfg["model"]["layer_types"][:4],
                        yarn_original_max_position=64, vocab_size=97, max_seq_len=512,
                        dtype="float32", param_dtype="float32")
    cfg["engine"] = dict(max_batch=4, max_context=256, page_size=128, total_pages=9,
                         prefix_caching=False, decode_block_steps=4, per_request_sampling=True,
                         sampling_kmax=64, prompt_buckets=[32, 64, 128], max_prefill_tokens=128)
    mix = dict(MIX, clients=4, pool=64, warmup_s=0.3,
               prompt=dict(MIX["prompt"], median=40, min=20, max=120),
               output=dict(MIX["output"], median=24, min=17, max=60))
    return types.SimpleNamespace(
        config=cfg, mix=mix, limits=_json("limits", "mellum2.code_chat_8k.json"), seed=seed,
        seconds=1.5, trace=False, device=torch.device("cpu"), chips=1, rec=harness.Recorder(),
        process_start=time.time(), control=control, rate=None)


def test_a_tiny_run_is_correct_and_its_control_is_not_closer():
    """The driver end to end at a tiny fp32 size: correct, the budget's
    keys only, the counter read at every step; the fp8 control's gaps lie
    above the program's."""
    torch.set_num_threads(2)
    ctx = _tiny_ctx(control=True)
    out = sh.run(ctx)
    assert harness.within(out["checks"]), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    c = out["record"]["counters"]
    assert c["kv_share_steps"] > 0 and c["decode_rows"] > 0 and c["forward_least_s"] > 0
    assert 0 < harness.load_reader("kv_window_dead_share")(out["record"]) < 100
    info = out["info"]
    assert info["control_mean_logit_gap"] > out["checks"]["mean_logit_gap"]["value"]


@pytest.mark.cuda
def test_the_cells_control_fails_on_the_card():
    """On the card at the cell's own size: the program's gaps lie within the
    cell's limits and the control's (the reference held in fp8 in the
    program's place) exceed one of them.  These are the readings the
    limits sit between: ``python -m pytest --noconftest -m cuda
    benchmark/tests/test_bench_hybrid.py`` prints them on failure, and
    ``python benchmark/control.py`` cannot give them, since it routes only
    ``kind == "serve"`` to ``serve_readings``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's own size)")
    from benchmark.control import serve_readings
    from benchmark.run import make_ctx

    workload, seed = "mellum2.code_chat_8k", 2**31 + 2023
    _, ctx = make_ctx(workload, seed, 10.0)
    row = serve_readings(workload, seed, 10.0)
    print(json.dumps(row))
    for name in ("mean_logit_gap", "sampled_set_gap"):
        assert row[f"program_{name}"] <= ctx.limits[name], row
    assert any(row[f"control_{k}"] > v for k, v in ctx.limits.items()), row
