"""The plain reference against the program's CPU path (this test imports
both; the reference imports nothing of the program)."""

import ast
import os
import time

import numpy as np
import pytest
import torch

from gpubench import corpus, generate, run, weights
from gpubench.reference import bert as ref_bert
from gpubench.reference.wordpiece import Tokenizer

from .conftest import LIMIT, tiny_config

SEED = 2 ** 31 + 777


def test_wordpiece_matches_the_program():
    from bert_tpu_torch.tokenizer import WordPieceTokenizer
    from bert_tpu_torch.vocab import Vocab

    corp = corpus.load()
    vocab = list(corp.vocab)
    # sub-word pieces, so that the longest-match path is exercised too
    for i, piece in enumerate(["##ing", "##s", "##ed", "run", "##ning",
                               "un", "##believ", "##able"]):
        vocab[2000 + i] = piece
    ours = Tokenizer(vocab)
    theirs = WordPieceTokenizer(Vocab.from_tokens(vocab), warn_unknown=False)
    texts = corp.sentences + [
        "Running unbelievable things, 42x at CAFÉ Ñandú!! ~ 3.14", "",
        "ééé ümlaut naïve", "a" * 120, "x" * 600 + " y",
        " ".join(corp.sentences[:80])]
    for cap in (512, 16, 3):
        for t in texts:
            assert ours(t, cap) == theirs.tokenize(t, cap), (t, cap)


def test_dequant_matches_the_program():
    from bert_tpu_torch.quant import q4_0_dequantize, q4_from_ggml_bytes

    g = torch.Generator().manual_seed(5)
    nib = torch.randint(0, 256, (96, 16), generator=g, dtype=torch.uint8)
    scale = torch.rand(96, generator=g).to(torch.float16).float()
    rec = torch.cat([scale.view(torch.uint8).view(-1, 4), nib], 1)
    codes, scales, _ = q4_from_ggml_bytes(rec.numpy().tobytes(), (3, 1024),
                                          2)
    want = q4_0_dequantize(codes, scales)
    got = ref_bert.dequant_q4_0(nib, scale, (3, 1024)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cell", ["tiny.sentences", "tiny.passages"])
def test_reference_agrees_with_the_cpu_path(tiny, cell):
    bench, reg = tiny
    r = run.execute(bench, cell, SEED, 0.5, False, "cpu", reg,
                    time.monotonic())
    assert r["correct"], r["checks"]
    assert r["notes"]["compared"] >= 3
    assert r["checks"]["emb_gap_max"]["value"] < LIMIT


@pytest.mark.parametrize("control", ["int8_eval", "bfloat16", "fp8"])
def test_controls_are_not_correct(tiny, control):
    """The tiny configuration states float32. Each control of the step
    below fails its limit: the program with its own int8 path switched on
    (the control of the cells on the card), the program in bfloat16, and
    the reference computed in float8 put in the program's place."""
    bench, reg = tiny
    over = {"int8_eval": {"int8_eval": True, "int8_threshold": 0},
            "bfloat16": {"compute_dtype": "bfloat16", "wire_dtype": "f16"},
            "fp8": {}}[control]
    r = run.execute(bench, "tiny.sentences", SEED, 0.5, False, "cpu", reg,
                    time.monotonic(), keep_answers=True,
                    engine_overrides=over)
    if control != "fp8":
        assert not r["correct"]
        assert r["checks"]["emb_gap_max"]["value"] > 10 * LIMIT
        return
    assert r["correct"]
    cell = run.make_cell(bench, "tiny.sentences", SEED, 0.5, False, "cpu",
                         reg, time.monotonic())
    texts = [t for t, _ in r["answers"]]
    f32 = run.reference_embeddings(cell, texts)
    fp8 = run.reference_embeddings(cell, texts, precision="fp8")
    assert np.linalg.norm(fp8 - f32, axis=1).max() > 10 * LIMIT


def test_weights_file_loads_in_the_program():
    from bert_tpu_torch.formats.ggml_bin import read_ggml

    cfg = tiny_config()
    w = weights.draw(cfg, 9, torch.device("cpu"))
    again = weights.draw(cfg, 9, torch.device("cpu"))
    assert all(torch.equal(a[0], b[0]) if isinstance(a, tuple) else
               torch.equal(a, b) for a, b in zip(w.values(), again.values()))
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"gpubench-test-{os.getpid()}.bin")
    try:
        weights.write_ggml(path, cfg, corpus.load().vocab, w)
        mf = read_ggml(path)
        name = "encoder.layer.1.intermediate.dense.weight"
        nib, scale, shape = w[name]
        assert np.array_equal(mf.tensors[name].to_f32(),
                              ref_bert.dequant_q4_0(nib, scale,
                                                    shape).numpy())
        assert mf.hparams.n_vocab == 30522 and mf.hparams.ftype == 2
    finally:
        os.unlink(path)


def test_reference_imports_nothing_of_the_program():
    here = os.path.join(os.path.dirname(ref_bert.__file__))
    for name in os.listdir(here):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("bert_tpu_torch", "bert_tpu",
                                               "jax", "gpubench"), (name, m)


def test_same_seed_same_inputs():
    a = generate.rng(SEED, generate.TEXTS).integers(1 << 30, size=4)
    b = generate.rng(SEED, generate.TEXTS).integers(1 << 30, size=4)
    assert np.array_equal(a, b)
