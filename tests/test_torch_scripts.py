"""The port's LM scripts, driven in-process through their ``main(argv)``.

  * ``train.main`` on the CPU with the arguments of
    tests/test_data_and_scripts.py (xsmall, B=2, T=32, an eval every 4
    steps, 512 tokens): it writes ``best_model``, the regular
    ``checkpoint_tokens_seen_N`` files, their meta, its log and its plot
    into ``--ckpt-dir`` and nothing into the working directory;
    ``--resume`` continues ``tokens_seen`` from the checkpoint's;
    ``--mesh`` and ``--multihost`` raise.
  * ``serve.main`` from a port checkpoint converted from a ``vats_tpu``
    checkpoint (xsmall at 2 layers, fp32, saved with orbax, carried over
    with ``train_state_from_jax``): its greedy tokens for every request
    equal those of ``vats_tpu``'s ServingEngine fed the same stream by the
    loop of scripts/nlp/serve.py (no tolerance: greedy argmax on the same
    weights; tests/test_torch_serving.py holds the two engines equal).
  * ``interactive_generation.main`` from that checkpoint at temperature 0
    (dense, ``--paged``, ``--kv-quant int8``) with a character tokenizer
    and a scripted stdin ending in 'quit': one output per prompt before it,
    equal to ``vats_tpu``'s ``TokenGenerator`` on the JAX params.

Every test runs in ``tmp_path``; nothing is written into the repository.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.checkpoint import load_checkpoint as j_load_checkpoint
from vats_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from vats_tpu.configs import GenerationArgs as JGenerationArgs
from vats_tpu.configs import TrainingArgs as JTrainingArgs
from vats_tpu.configs import nlp_xsmall as j_nlp_xsmall
from vats_tpu.inference import ServingEngine as JServingEngine
from vats_tpu.inference import TokenGenerator as JTokenGenerator
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.train import create_optimizer as j_create_optimizer
from vats_tpu.train import create_train_state as j_create_train_state
from vats_tpu_torch.checkpoint import save_checkpoint
from vats_tpu_torch.configs import ModelArgs, TrainingArgs
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.scripts.nlp import interactive_generation, serve, train
from vats_tpu_torch.train import create_optimizer
from vats_tpu_torch.utils.convert import train_state_from_jax

torch.set_num_threads(1)

TRAIN_ARGS = ["--size", "xsmall", "--max-train-tokens", "512", "--batch-size", "2",
              "--seq-len", "32", "--eval-every-steps", "4", "--device", "cpu"]


class CharTokenizer:
    pad_token_id = 0
    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 90 + 1 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i + 31) for i in ids)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


# --- train ------------------------------------------------------------------


def test_train_writes_checkpoints_and_resume_continues(in_tmp):
    ckpt = str(in_tmp / "ckpt")
    out = train.main(TRAIN_ARGS + ["--ckpt-dir", ckpt])
    rounds = out["rounds"]
    assert len(rounds) >= 2 and all(r["val_batches"] == 20 for r in rounds)
    tokens = int(out["state"].tokens_seen)
    assert tokens >= 512 and rounds[-1]["tokens_seen"] == tokens
    files = set(os.listdir(ckpt))
    assert {"best_model", "best_model.meta.json", f"checkpoint_tokens_seen_{tokens}",
            f"checkpoint_tokens_seen_{tokens}.meta.json", "logs"} <= files
    for r in rounds:  # one regular checkpoint per evaluation
        assert os.path.basename(r["saved"]["regular"]) == \
            f"checkpoint_tokens_seen_{r['tokens_seen']}"
        assert os.path.exists(r["saved"]["regular"] + ".meta.json")
    assert os.path.exists(os.path.join(ckpt, "logs", "training.log"))
    # the plot goes next to the checkpoints, never into the working directory
    assert os.listdir(in_tmp) == ["ckpt"]
    with open(os.path.join(ckpt, "best_model.meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"model_args", "training_args", "tokens_seen", "loss", "is_best"}
    assert meta["is_best"] is True
    assert ModelArgs.from_dict(meta["model_args"]) == out["model_args"]
    assert meta["training_args"]["batch_size"] == 2
    assert meta["loss"] == min(out["history"]["val_loss"])

    regular = os.path.join(ckpt, f"checkpoint_tokens_seen_{tokens}")
    budget = tokens + 4 * 2 * 31  # one more round of 4 steps at most
    res = train.main(["--size", "small", "--max-train-tokens", str(budget),
                      "--batch-size", "2", "--seq-len", "32", "--eval-every-steps", "4",
                      "--device", "cpu", "--ckpt-dir", ckpt, "--resume", regular])
    # model args restored from the checkpoint, not from the tier flag
    assert res["model_args"] == out["model_args"]
    first = res["rounds"][0]
    assert first["steps"] >= 1 and tokens < first["tokens_seen"] <= budget
    assert int(res["state"].tokens_seen) >= budget - 2 * 31
    assert np.isfinite(res["history"]["train_loss"]).all()


@pytest.mark.parametrize("flag,match", [
    (["--mesh", "fsdp=2"], "device count 1"),  # a mesh larger than this one-rank world
    (["--multihost"], "backend"),  # no backend given (the caller's choice, never guessed)
], ids=["flag0", "flag1"])
def test_train_sharded_flags_raise(in_tmp, flag, match):
    """The sharded flags train (tests/test_torch_sharded.py); what they
    cannot lay out raises before anything is written."""
    with pytest.raises(ValueError, match=match):
        train.main(TRAIN_ARGS + ["--ckpt-dir", str(in_tmp / "c")] + flag)
    assert not os.path.exists(in_tmp / "c")


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(TRAIN_ARGS[:-2] + ["--ckpt-dir", "unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
    assert not os.path.exists("unused")


# --- serve a checkpoint converted from vats_tpu ---------------------------------


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(JAX model, JAX params, port checkpoint path): vats_tpu's state saved
    with orbax, restored, converted and saved by the port."""
    d = tmp_path_factory.mktemp("converted")
    jcfg = j_nlp_xsmall(num_layers=2, dropout=0.0, dtype="float32",
                        gradient_checkpointing=False)
    jt = JTrainingArgs(grad_accum_steps=1)
    jm = JTextLM(jcfg)
    js = j_create_train_state(jm, j_create_optimizer(jt, 10), jax.random.PRNGKey(3),
                              jnp.zeros((1, 8), jnp.int32))
    jpath = j_save_checkpoint(str(d / "jax"), js, model_args=jcfg, training_args=jt,
                              is_best=True)
    restored, jmeta = j_load_checkpoint(jpath, target=jax.device_get(js))
    cfg = ModelArgs.from_dict(jmeta["model_args"])
    targs = TrainingArgs(grad_accum_steps=1)
    state = train_state_from_jax(restored, TextLM(cfg, device="cpu"), targs,
                                 create_optimizer(targs, 10))
    path = save_checkpoint(str(d / "port"), state, model_args=cfg, training_args=targs,
                           is_best=True)
    return jm, {"params": restored.params}, path


def jax_serve(jm, params, argv):
    """vats_tpu's engine fed the stream of scripts/nlp/serve.py:112-150."""
    a = serve.parse_args(argv)
    cfg = jm.cfg
    eng = JServingEngine(
        jm, params, max_batch=a.max_batch, max_context=a.max_context,
        page_size=a.page_size, total_pages=a.total_pages, kv_quant=a.kv_quant,
        do_sample=a.temperature > 0, temperature=a.temperature, seed=a.seed,
        decode_block_steps=a.decode_block_steps, prefix_caching=a.prefix_caching,
        spec_k=a.spec_k, per_request_sampling=a.per_request_sampling,
        overlap_scheduling=a.overlap_scheduling,
    )
    rng = np.random.default_rng(a.seed)
    shared = rng.integers(1, cfg.vocab_size, size=a.shared_prefix_len).astype(int).tolist()
    for _ in range(a.requests):
        plen = max(1, a.prompt_len + int(rng.integers(-8, 9)))
        prompt = shared + rng.integers(1, cfg.vocab_size, size=plen).astype(int).tolist()
        eng.submit(prompt, max_new_tokens=a.max_new_tokens)
    results = {}
    while eng.queue or any(r is not None for r in eng.row_request):
        for req in eng.step():
            results[req.rid] = req.output_ids
    return results, eng


SERVE_CASES = {
    "blocks": ["--decode-block-steps", "4"],
    "int8_kv_prefix": ["--kv-quant", "int8", "--prefix-caching", "--shared-prefix-len",
                       "40", "--seed", "2"],
    "spec_k": ["--spec-k", "3", "--total-pages", "3", "--seed", "5"],
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_checkpoint_converted_from_jax_equals_jax_engine(converted, in_tmp, case,
                                                               capsys):
    jm, params, path = converted
    argv = ["--ckpt", path, "--cpu", "--requests", "6", "--max-new-tokens", "8",
            "--max-batch", "4"] + SERVE_CASES[case]
    got = serve.main(argv)
    want, jeng = jax_serve(jm, params, argv)
    assert len(got["outputs"]) == 6 and got["outputs"].keys() == want.keys()
    for rid in want:
        assert len(got["outputs"][rid]) == 8
        assert got["outputs"][rid] == want[rid], rid
    assert got["preemptions"] == jeng.preemptions
    assert got["total_tokens"] == 48 and got["tokens_per_s"] > 0
    kind = "verify" if "--spec-k" in argv else "decode"
    assert got["forwards"][kind] > 0 and got["num_layers"] == 2
    assert capsys.readouterr().out.startswith("served 6 requests, 48 tokens")


def test_serve_random_weights_from_a_tier(in_tmp, capsys):
    got = serve.main(["--cpu", "--config", "xsmall", "--requests", "3", "--max-new-tokens",
                      "4", "--max-context", "128", "--per-request-sampling",
                      "--temperature", "0.5"])
    assert sorted(got["outputs"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in got["outputs"].values())
    assert "served 3 requests" in capsys.readouterr().out


# --- interactive generation ---------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--paged"], ["--kv-quant", "int8"]])
def test_interactive_generation_with_a_scripted_stdin(converted, in_tmp, flags, capsys):
    jm, params, path = converted
    stdin = io.StringIO("Once upon a time,\nhello world\nquit\nnever read\n")
    argv = ["--ckpt", path, "--device", "cpu", "--max-new-tokens", "6",
            "--temperature", "0"] + flags
    outs = interactive_generation.main(argv, tokenizer=CharTokenizer(), stdin=stdin)
    assert len(outs) == 2 and all(len(o) == 6 for o in outs)
    printed = capsys.readouterr().out
    assert printed.startswith("Interactive generation") and printed.count("> ") == 3

    # vats_tpu's generator on the JAX params the checkpoint was converted
    # from, with the GenerationArgs of scripts/nlp/interactive_generation.py
    # (greedy with its repetition penalty; no tolerance: argmax of the same
    # fp32 weights)
    tok = CharTokenizer()
    jgen = JTokenGenerator(jm.cfg, params=params,
                           use_paged="--paged" in flags or "--kv-quant" in flags,
                           kv_quant="int8" if "--kv-quant" in flags else None)
    gen_args = JGenerationArgs(max_new_tokens=6, temperature=0.0,
                               pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id)
    want = [jgen.generate_tokens(p, gen_args, tok) for p in ("Once upon a time,",
                                                             "hello world")]
    assert outs == want
    # end of input ends the loop as 'quit' does
    assert interactive_generation.main(argv, tokenizer=tok, stdin=io.StringIO("")) == []
