"""The port's loaders on the CPU against bert_tpu's: HF checkpoint
directories (``model.safetensors`` through the port's own reader, and
``pytorch_model.bin``) and the ``.npz`` weight cache, read across in both
directions.

Fixture directories hold random weights at small widths with d_head = 26
(rubert-tiny2's head dim), made from a seed; ``write_hf_dir`` is shared by
the port's engine and server tests. Comparisons are exact: both packages
read the same bytes and build the tree with the same numpy calls.
"""

import json
import os

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from bert_tpu import checkpoint as jckpt
from bert_tpu.loader import load_model as j_load_model
from bert_tpu.params import BertConfig as JConfig
from bert_tpu.params import params_from_named_tensors as j_params_from_named
from bert_tpu_torch import checkpoint as tckpt
from bert_tpu_torch.formats.safetensors import read_safetensors
from bert_tpu_torch.loader import load_model
from bert_tpu_torch.params import BertConfig, random_named_tensors
from fixture_vocab import build_fixture_tokens

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

# d_head = 52 / 2 = 26: outside the fused kernel's instances
HF_SMALL = dict(n_vocab=30522, n_max_tokens=256, n_embd=52,
                n_intermediate=96, n_head=2, n_layer=2)


def write_hf_dir(path, cfg_kw=HF_SMALL, *, seed=0, fmt="bin",
                 pooling="cls", prefix="", extra_tokens=0,
                 hidden_act="gelu", f16=False) -> str:
    """A random-weight HF BERT checkpoint directory: config.json, the
    weights (``fmt`` "bin" → pytorch_model.bin, "safetensors" →
    model.safetensors) with the position_ids buffer and pooler a real
    checkpoint carries, vocab.txt (the fixture vocab, plus
    ``extra_tokens`` added tokens past vocab_size) and, unless ``pooling``
    is None, 1_Pooling/config.json."""
    os.makedirs(path, exist_ok=True)
    cfg = BertConfig(**cfg_kw)
    named = {prefix + k: np.array(v, dtype=np.float16 if f16 else np.float32)
             for k, v in random_named_tensors(cfg, seed).items()}
    d = cfg.n_embd
    named[prefix + "pooler.dense.weight"] = np.ones((d, d), np.float32)
    named[prefix + "pooler.dense.bias"] = np.zeros(d, np.float32)
    named[prefix + "embeddings.position_ids"] = np.arange(
        cfg.n_max_tokens, dtype=np.int64)[None]
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in named.items()},
                   os.path.join(path, "pytorch_model.bin"))
    else:
        save_file(named, os.path.join(path, "model.safetensors"),
                  metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["BertModel"], "model_type": "bert",
                   "vocab_size": cfg.n_vocab,
                   "max_position_embeddings": cfg.n_max_tokens,
                   "hidden_size": d, "intermediate_size": cfg.n_intermediate,
                   "num_attention_heads": cfg.n_head,
                   "num_hidden_layers": cfg.n_layer, "hidden_act": hidden_act,
                   "layer_norm_eps": 1e-12}, f)
    tokens = build_fixture_tokens()[: cfg.n_vocab]
    tokens += [f"[added{i}]" for i in range(extra_tokens)]
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    if pooling is not None:
        os.makedirs(os.path.join(path, "1_Pooling"), exist_ok=True)
        with open(os.path.join(path, "1_Pooling", "config.json"), "w") as f:
            json.dump({"word_embedding_dimension": d,
                       "pooling_mode_cls_token": pooling == "cls",
                       "pooling_mode_mean_tokens": pooling == "mean"}, f)
    return str(path)


def _leaves(params):
    """group/key(.field) → numpy array, for comparing two trees."""
    out = {}
    for group, sub in params.items():
        for key, v in sub.items():
            if hasattr(v, "packed"):
                out[f"{group}/{key}.packed"] = np.asarray(v.packed)
                out[f"{group}/{key}.scales"] = np.asarray(v.scales)
                if v.mins is not None:
                    out[f"{group}/{key}.mins"] = np.asarray(v.mins)
            else:
                out[f"{group}/{key}"] = np.asarray(v)
    return out


def _assert_same_model(got, want):
    assert got.config.__dict__ == want.config.__dict__
    assert got.vocab.tokens == want.vocab.tokens
    assert got.pooling == want.pooling
    a, b = _leaves(got.params), _leaves(want.params)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_safetensors_reader_matches_the_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "w32": rng.standard_normal((7, 5)).astype(np.float32),
        "w16": rng.standard_normal((3, 4, 2)).astype(np.float16),
        "scalar": np.array(3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "position_ids": np.arange(9, dtype=np.int64)[None],
    }
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = read_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "m.safetensors")
    save_file({"ids": np.arange(4, dtype=np.int32)}, path)
    with pytest.raises(ValueError, match="I32"):
        read_safetensors(path)


@pytest.mark.parametrize("fmt,prefix,f16", [
    ("safetensors", "", False), ("safetensors", "bert.", True),
    ("bin", "", False), ("bin", "bert.", True)])
def test_hf_dir_loads_as_bert_tpu_loads_it(tmp_path, fmt, prefix, f16):
    path = write_hf_dir(tmp_path / "hf", fmt=fmt, prefix=prefix, f16=f16,
                        extra_tokens=3, pooling="cls")
    got = load_model(path)
    _assert_same_model(got, j_load_model(path))
    assert got.pooling == "cls" and got.config.d_head == 26
    assert len(got.vocab) == HF_SMALL["n_vocab"]  # added tokens cut
    assert set(got.load_phases) >= {"parse", "repack"}


@pytest.mark.parametrize("pooling,act", [("mean", "gelu_new"),
                                         (None, "gelu")])
def test_hf_dir_pooling_and_activation(tmp_path, pooling, act):
    path = write_hf_dir(tmp_path / "hf", pooling=pooling, hidden_act=act)
    got = load_model(path)
    assert got.pooling == pooling
    assert got.config.gelu_approx == (act == "gelu_new")
    _assert_same_model(got, j_load_model(path))


def test_hf_dir_quantize_on_load(tmp_path):
    cfg_kw = dict(HF_SMALL, n_embd=128, n_intermediate=256, n_head=4)
    path = write_hf_dir(tmp_path / "hf", cfg_kw, fmt="safetensors")
    got = load_model(path, quantize_ftype=2)
    assert got.config.ftype == 2 and hasattr(got.params["layers"]["qkv_w"],
                                             "packed")
    _assert_same_model(got, j_load_model(path, quantize_ftype=2))


def _tree(ftype):
    cfg = JConfig(**dict(HF_SMALL, n_embd=64, n_intermediate=128, n_head=2))
    named = random_named_tensors(BertConfig(**cfg.__dict__), 5)
    return cfg, j_params_from_named(named, cfg, quantize_ftype=ftype)


@pytest.mark.parametrize("ftype", [None, 2, 3], ids=["f32", "q4_0", "q4_1"])
@pytest.mark.parametrize("writer", ["bert_tpu", "port"])
def test_npz_cache_cross_reads(tmp_path, ftype, writer):
    import jax

    cfg, jtree = _tree(ftype)
    host = jax.tree_util.tree_map(np.asarray, jtree)
    tokens = build_fixture_tokens()
    path = str(tmp_path / "cache.npz")
    if writer == "bert_tpu":
        jckpt.save_params(path, host, cfg, tokens, pooling="cls")
        tcfg, tparams, ttok, tpool = tckpt.load_params_and_vocab(path)
        got = load_model(path)
        assert got.pooling == "cls" and got.vocab.tokens == tokens
        assert got.config == tcfg
    else:
        tckpt.save_params(path, host, BertConfig(**cfg.__dict__), tokens,
                          pooling="cls")
        jcfg, tparams, ttok, tpool = jckpt.load_params_and_vocab(path)
        assert jcfg == cfg
    assert ttok == tokens and tpool == "cls"
    a, b = _leaves(tparams), _leaves(host)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_npz_cache_rejects_bad_paths_and_versions(tmp_path):
    cfg, jtree = _tree(None)
    with pytest.raises(ValueError, match=".npz"):
        tckpt.save_params(str(tmp_path / "cache.bin"), jtree,
                          BertConfig(**cfg.__dict__))
    path = str(tmp_path / "v0.npz")
    np.savez(path, __meta__=json.dumps(dict(cfg.__dict__)))
    with pytest.raises(ValueError, match="version"):
        load_model(path)
    path = str(tmp_path / "novocab.npz")
    tckpt.save_params(path, jtree, BertConfig(**cfg.__dict__))
    with pytest.raises(ValueError, match="vocab"):
        load_model(path)
