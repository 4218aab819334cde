"""The port's data layer against ``vats_tpu``'s: text filters, TextDataset,
the token-shard loader and host-to-device feeding.

Counterparts of tests/test_data_and_scripts.py (filters, datasets) and
tests/test_shard_dataset.py (shards, packing), run on the port's modules;
each also runs ``vats_tpu``'s module on the same inputs and requires equal
outputs (no tolerance: the same integer and string work on both sides).
The port builds its own C loader from ``vats_tpu_torch/data/native``; its
output equals the numpy packer's and the JAX package's native output."""

import ctypes
import os

import numpy as np
import pytest
import torch

from vats_tpu.data import shard_dataset as j_shard
from vats_tpu.data import text_cleaning as j_clean
from vats_tpu.data import text_dataset as j_text
from vats_tpu_torch.data import device_batches, shard_dataset, text_cleaning, text_dataset
from vats_tpu_torch.data.shard_dataset import ShardDataset, TokenShard
from vats_tpu_torch.train.metrics import IGNORE_INDEX

torch.set_num_threads(1)

GOOD_TEXT = (
    "The history of computing spans several centuries of human ingenuity. "
    "Early mechanical calculators gave way to electronic machines during the "
    "twentieth century. Researchers developed programming languages to make "
    "these machines useful for science and commerce. Today, computers power "
    "nearly every aspect of modern life, from communication to medicine."
)

TEXTS = [
    GOOD_TEXT,
    "short",
    "日本語のテキスト" * 50,
    "a " * 200,
    "Visit https://example.com or mail me@site.org or call 555-123-4567!!!!!",
    GOOD_TEXT.upper(),
    "  " + GOOD_TEXT.replace("modern life", "daily life") + "  \n\n\n\n\n end",
    "Line one.\nLine one.\nLine one.\nLine one.\n“Quoted” ‘text’ here... ok?",
    GOOD_TEXT + " " + GOOD_TEXT,
    "",
]


class CharTokenizer:
    pad_token_id = 0
    eos_token_id = None

    def encode(self, text):
        return [ord(c) % 90 + 1 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i + 31) for i in ids)


# --- text filters -----------------------------------------------------------


def test_quality_filter_accepts_good_and_rejects_bad_text():
    f = text_cleaning.TextQualityFilter()
    out = f.filter_text(GOOD_TEXT)
    assert out is not None and len(out) > 100
    assert f.filter_text("short") is None
    assert f.filter_text("日本語のテキスト" * 50) is None  # non-English
    assert f.filter_text("a " * 200) is None  # degenerate words
    batch = f({"text": [GOOD_TEXT, "short"]})
    assert batch["text"][0] is not None and batch["text"][1] is None


def test_quality_filter_cleaning():
    cleaned = text_cleaning.TextQualityFilter().clean_text(
        "Visit https://example.com or mail me@site.org or call 555-123-4567!!!!!"
    )
    for gone in ("https", "@", "555", "!!!!"):
        assert gone not in cleaned


@pytest.mark.parametrize("min_length", [20, 100])
def test_quality_filter_equals_jax(min_length):
    """Cleaned text, English check, score and the filter's decision are equal
    to vats_tpu's for every text (same rules in the same order)."""
    t = text_cleaning.TextQualityFilter(min_length=min_length, max_length=300)
    j = j_clean.TextQualityFilter(min_length=min_length, max_length=300)
    for text in TEXTS:
        assert t.clean_text(text) == j.clean_text(text)
        assert t.is_english(text) == j.is_english(text)
        assert t.calculate_quality_score(text) == j.calculate_quality_score(text)
        for q in (0.0, 0.3, 0.5):
            assert t.filter_text(text, q) == j.filter_text(text, q)
    assert t({"text": TEXTS}) == j({"text": TEXTS})


def test_dedup_exact_and_near():
    d = text_cleaning.DeduplicationFilter(similarity_threshold=0.8)
    assert not d.is_duplicate(GOOD_TEXT)
    assert d.is_duplicate(GOOD_TEXT)
    assert d.is_duplicate("  " + GOOD_TEXT.upper() + " ")
    d2 = text_cleaning.DeduplicationFilter(similarity_threshold=0.5)
    assert not d2.is_near_duplicate(GOOD_TEXT)
    assert d2.is_near_duplicate(GOOD_TEXT.replace("modern life", "daily life"))
    assert not d2.is_near_duplicate("completely different content about cats")
    out = text_cleaning.DeduplicationFilter()({"text": [GOOD_TEXT, GOOD_TEXT, None]})
    assert out["text"][0] is not None and out["text"][1] is None and out["text"][2] is None


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.85])
def test_dedup_decisions_equal_jax(threshold):
    t = text_cleaning.DeduplicationFilter(similarity_threshold=threshold)
    j = j_clean.DeduplicationFilter(similarity_threshold=threshold)
    stream = TEXTS + TEXTS[::-1]
    for text in stream:
        assert t.get_text_hash(text) == j.get_text_hash(text)
        assert t.get_shingles(text, 3) == j.get_shingles(text, 3)
        assert t.is_near_duplicate(text) == j.is_near_duplicate(text)
    t2 = text_cleaning.DeduplicationFilter(similarity_threshold=threshold)
    j2 = j_clean.DeduplicationFilter(similarity_threshold=threshold)
    assert t2({"text": stream + [None]}) == j2({"text": stream + [None]})


# --- TextDataset ------------------------------------------------------------


def test_text_dataset_labels_shifted():
    ds = text_dataset.TextDataset.from_texts(["hello world example"], CharTokenizer(), 32)
    row = ds[0]
    ids, labels = row["input_ids"], row["labels"]
    n = int(row["padding_mask"].sum())
    np.testing.assert_array_equal(labels[: n - 1], ids[1:n])
    assert labels[n - 1] == IGNORE_INDEX
    assert (labels[n:] == IGNORE_INDEX).all()


def _dataset_texts():
    rs = np.random.RandomState(0)
    return [f"sample text number {i} with content " + "x" * int(rs.randint(0, 60))
            for i in range(23)] + ["a"]  # one text too short to keep


def test_text_dataset_examples_batches_and_split_equal_jax():
    texts = _dataset_texts()
    tds = text_dataset.TextDataset.from_texts(texts, CharTokenizer(), 48)
    jds = j_text.TextDataset.from_texts(texts, CharTokenizer(), 48)
    assert len(tds) == len(jds) == 23
    for i in range(len(tds)):
        a, b = tds[i], jds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False), dict(drop_last=False),
               dict(epochs=2, seed=1)):
        tb, jb = list(tds.batches(4, **kw)), list(jds.batches(4, **kw))
        assert len(tb) == len(jb) > 0
        for x, y in zip(tb, jb):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{kw} {k}")
    (ttr, tval), (jtr, jval) = (text_dataset.train_val_split(tds, 0.2, seed=7),
                                j_text.train_val_split(jds, 0.2, seed=7))
    assert len(ttr) == 19 and len(tval) == 4
    for x, y in ((ttr, jtr), (tval, jval)):
        np.testing.assert_array_equal(np.stack(x.examples), np.stack(y.examples))
        assert x.pad_token_id == y.pad_token_id


# --- token shards -----------------------------------------------------------


def make_shard():
    docs = [
        [5, 6, 7, 8],
        [9, 10],
        list(range(20, 45)),  # longer than seq_len
        [11, 12, 13],
        [14],
    ]
    return TokenShard.from_documents(docs), docs


def random_docs(seed, n, lo, hi, vocab=1000):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, rs.randint(lo, hi + 1)).tolist() for _ in range(n)]


def test_native_library_is_built_from_the_ports_source():
    lib = shard_dataset.load_native()
    path = shard_dataset.lib_path()
    assert path.parent == shard_dataset.BUILD_DIR
    assert shard_dataset.BUILD_DIR.name == "_build"
    assert shard_dataset.BUILD_DIR.parent.name == "vats_tpu_torch"
    assert shard_dataset.SOURCE.parts[-4:] == ("vats_tpu_torch", "data", "native",
                                                "shard_loader.c")
    assert path.exists() and lib._name == str(path)
    assert isinstance(lib.pack_sequences, ctypes._CFuncPtr)
    assert "vats_tpu/data" not in str(path) and "libvats_shard" not in path.name


def test_pack_batch_semantics():
    shard, _ = make_shard()
    ds = ShardDataset(shard, seq_len=8, pad_id=0)
    batch = ds.pack_batch(np.array([0, 1, 2]))
    ids, labels, mask = batch["input_ids"], batch["labels"], batch["padding_mask"]
    np.testing.assert_array_equal(ids[0, :4], [5, 6, 7, 8])
    assert (ids[0, 4:] == 0).all()
    np.testing.assert_array_equal(labels[0, :3], [6, 7, 8])
    assert (labels[0, 3:] == IGNORE_INDEX).all()
    np.testing.assert_array_equal(mask[0], [1, 1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(ids[2], list(range(20, 28)))
    assert labels[2, 7] == IGNORE_INDEX
    np.testing.assert_array_equal(labels[2, :7], list(range(21, 28)))
    with pytest.raises(IndexError):
        ds.pack_batch(np.array([0, 5]))
    with pytest.raises(IndexError):
        ds.pack_sequences(6, 1)


@pytest.mark.parametrize("seq_len,pad_id", [(8, 0), (128, 3)])
def test_native_pack_batch_equals_numpy_and_jax(seq_len, pad_id):
    shard = TokenShard.from_documents(random_docs(1, 300, 1, 200))
    jshard = j_shard.TokenShard(shard.tokens, shard.offsets)
    ds = ShardDataset(shard, seq_len=seq_len, pad_id=pad_id)
    jds = j_shard.ShardDataset(jshard, seq_len=seq_len, pad_id=pad_id)
    idx = np.random.RandomState(2).randint(0, 300, 64)
    fast = ds.pack_batch(idx)
    ids = np.empty((64, seq_len), np.int32)
    labels = np.empty((64, seq_len), np.int32)
    mask = np.empty((64, seq_len), np.uint8)
    ds._pack_batch_numpy(idx.astype(np.int64), ids, labels, mask)
    want = jds.pack_batch(idx)
    np.testing.assert_array_equal(fast["input_ids"], ids)
    np.testing.assert_array_equal(fast["labels"], labels)
    np.testing.assert_array_equal(fast["padding_mask"], mask.astype(bool))
    for k in want:
        np.testing.assert_array_equal(fast[k], want[k], err_msg=k)
        assert fast[k].dtype == want[k].dtype


def test_pack_sequences_segments():
    shard, _ = make_shard()
    ds = ShardDataset(shard, seq_len=8, pad_id=0)
    batch, consumed = ds.pack_sequences(0, batch_size=2)
    ids, labels, segs = batch["input_ids"], batch["labels"], batch["segment_ids"]
    np.testing.assert_array_equal(ids[0, :6], [5, 6, 7, 8, 9, 10])
    np.testing.assert_array_equal(segs[0, :6], [1, 1, 1, 1, 2, 2])
    assert (segs[0, 6:] == 0).all()
    assert labels[0, 3] == IGNORE_INDEX
    np.testing.assert_array_equal(labels[0, :3], [6, 7, 8])
    assert labels[0, 4] == 10
    assert labels[0, 5] == IGNORE_INDEX
    np.testing.assert_array_equal(ids[1], list(range(20, 28)))
    assert consumed == 3


@pytest.mark.parametrize("seq_len,lo,hi", [(16, 1, 24), (512, 32, 600)])
def test_pack_sequences_equals_jax(seq_len, lo, hi):
    """Every packed array (segment ids included) and the documents consumed
    equal vats_tpu's, batch after batch to the end of the shard."""
    shard = TokenShard.from_documents(random_docs(4, 120, lo, hi))
    jshard = j_shard.TokenShard(shard.tokens, shard.offsets)
    ds, jds = ShardDataset(shard, seq_len), j_shard.ShardDataset(jshard, seq_len)
    doc = 0
    while doc < shard.num_docs:
        (got, n), (want, jn) = ds.pack_sequences(doc, 4), jds.pack_sequences(doc, 4)
        assert n == jn
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"doc {doc} {k}")
        if n == 0:
            break
        doc += n
    tb = list(ds.batches(4, packed=True))
    jb = list(jds.batches(4, packed=True))
    assert len(tb) == len(jb) > 1
    for x, y in zip(tb, jb):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])


def test_shard_save_load_roundtrip(tmp_path):
    shard, _ = make_shard()
    path = os.path.join(tmp_path, "shard.npz")
    shard.save(path)
    loaded = TokenShard.load(path)
    np.testing.assert_array_equal(loaded.tokens, shard.tokens)
    np.testing.assert_array_equal(loaded.offsets, shard.offsets)
    ds = ShardDataset(loaded, seq_len=8)
    assert len(list(ds.batches(2, epochs=1, shuffle=False))) == 2
    # the JAX package reads the port's shard file and vice versa
    jloaded = j_shard.TokenShard.load(path)
    np.testing.assert_array_equal(jloaded.tokens, shard.tokens)
    shuffled = list(ds.batches(2, seed=5))
    jshuffled = list(j_shard.ShardDataset(jloaded, seq_len=8).batches(2, seed=5))
    for x, y in zip(shuffled, jshuffled):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])


# --- host -> device ---------------------------------------------------------


def test_device_batches_types_and_values():
    shard = TokenShard.from_documents(random_docs(5, 40, 2, 30))
    ds = ShardDataset(shard, seq_len=16)
    batches = list(ds.batches(4, packed=True))
    got = list(device_batches(iter(batches), "cpu"))
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert set(g) == set(b)
        for k in ("input_ids", "labels", "segment_ids"):
            assert g[k].dtype == torch.int32 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), b[k])
        assert g["padding_mask"].dtype == torch.bool
        np.testing.assert_array_equal(g["padding_mask"].numpy(), b["padding_mask"])
    ds_text = text_dataset.TextDataset.from_texts(_dataset_texts(), CharTokenizer(), 48)
    first = next(device_batches(ds_text.batches(2, shuffle=False), "cpu"))
    assert first["input_ids"].shape == (2, 48) and first["input_ids"].dtype == torch.int32


def test_device_batches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    batch = {"input_ids": np.zeros((1, 4), np.int64)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_batches(iter([batch]), "cuda"))
    assert next(device_batches(iter([batch]), "cpu"))["input_ids"].dtype == torch.int32


# --- a packed batch through the model -----------------------------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_packed_batch_through_the_model_equals_jax_and_isolates_segments(impl):
    """A packed batch (the port's C packer, ``device_batches``) through the
    port's TextLM equals ``vats_tpu``'s on the same batch and weights at
    every valid position (fp32, atol 2e-4 rtol 2e-3 as
    tests/test_torch_text_lm.py; a pad position attends to nothing and its
    logits are ignored, so the two attention paths fill it differently).  Then each row's
    first segment is re-drawn: the later segments come after it, so only
    the segment mask keeps their logits from moving; masked scores add
    exact zeros, so they are held to 1e-6 (bit-equal is expected).  'flash'
    runs the flash kernels' plain versions here."""
    import jax
    import jax.numpy as jnp
    from flax.linen import meta

    from vats_tpu.configs import ModelArgs as JArgs
    from vats_tpu.models import TextLM as JTextLM
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.utils.convert import params_from_jax

    args = dict(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                dropout=0.0, vocab_size=97, max_seq_len=64, left_window=-1,
                num_experts=1, top_k=1, dtype="float32", gradient_checkpointing=False)
    jm = JTextLM(JArgs(**args))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    cfg = ModelArgs(**args, attention_impl=impl)
    tm = TextLM(cfg, device="meta")
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    tm.load_state_dict(params_from_jax(pnp, cfg), assign=True)
    tm.eval()

    shard = TokenShard.from_documents(random_docs(6, 40, 4, 40, vocab=97))
    batch = next(device_batches(iter([ShardDataset(shard, 64).pack_sequences(0, 3)[0]]),
                                "cpu"))
    segs, mask = batch["segment_ids"], batch["padding_mask"]
    first, later = segs == 1, segs > 1
    assert int(later.any(1).sum()) >= 2
    redraw = torch.from_numpy(np.random.RandomState(7).randint(1, 97, segs.shape)).int()
    ids2 = torch.where(first, redraw, batch["input_ids"])
    assert bool((ids2 != batch["input_ids"]).any())

    def both(ids):
        jl, _, _ = jm.apply(params, jnp.asarray(ids.numpy()),
                            padding_mask=jnp.asarray(mask.numpy()),
                            segment_ids=jnp.asarray(segs.numpy()))
        with torch.no_grad():
            tl, _, _ = tm(ids, padding_mask=mask, segment_ids=segs)
        valid = mask.numpy()
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=2e-4,
                                   rtol=2e-3)
        return tl

    out1, out2 = both(batch["input_ids"]), both(ids2)
    torch.testing.assert_close(out2[later], out1[later], atol=1e-6, rtol=0)
    assert not torch.equal(out1[first], out2[first])
