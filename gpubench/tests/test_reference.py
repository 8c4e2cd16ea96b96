"""The plain reference against the program's CPU path (this test imports
both; the reference imports nothing of the program), and the bits of the
BERT architecture against digests of them taken before the architecture
was looked up by name."""

import ast
import hashlib
import os
import time

import numpy as np
import pytest
import torch

from gpubench import corpus, generate, run, weights
from gpubench.reference import bert as ref_bert
from gpubench.reference.wordpiece import Tokenizer
from gpubench.registry import PKG, Registry

from .conftest import LIMIT, tiny_config

SEED = 2 ** 31 + 777


def test_wordpiece_matches_the_program():
    from bert_tpu_torch.tokenizer import WordPieceTokenizer
    from bert_tpu_torch.vocab import Vocab

    corp = corpus.load(tiny_config())
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
        weights.write_ggml(path, cfg, corpus.load(cfg).vocab, w)
        mf = read_ggml(path)
        name = "encoder.layer.1.intermediate.dense.weight"
        nib, scale, shape = w[name]
        assert np.array_equal(mf.tensors[name].to_f32(),
                              ref_bert.dequant_q4_0(nib, scale,
                                                    shape).numpy())
        assert mf.hparams.n_vocab == 30522 and mf.hparams.ftype == 2
    finally:
        os.unlink(path)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("part", ["reference", "archs"])
def test_reference_imports_nothing_of_the_program(part):
    """The references import neither the program nor the harness, and an
    architecture's module imports neither the program nor any module of
    the harness that does."""
    here = os.path.join(PKG, part)
    names = sorted(n for n in os.listdir(here) if n.endswith(".py"))
    assert names
    program = ("bert_tpu_torch", "bert_tpu", "jax", "flax")
    for name in names:
        todo, seen = [os.path.join(here, name)], set()
        while todo:
            path = todo.pop()
            seen.add(path)
            for m in _imports(path):
                top = m.split(".")[0]
                assert top not in program, (name, path, m)
                if top != "gpubench":
                    continue
                assert part == "archs", (name, m)
                sub = os.path.join(os.path.dirname(PKG), *m.split("."))
                nxt = (sub + ".py" if os.path.exists(sub + ".py") else
                       os.path.join(sub, "__init__.py"))
                if nxt not in seen:
                    todo.append(nxt)


# sha256 of the BERT architecture's bits at the parent of the change that
# made architectures files of their own (412486c), from the code then:
# bert_base_q4_0's ggml file (weight seed 20261018, drawn on the CPU), the
# vocabulary (tokens joined by newlines) of both configurations, and the
# tiny configuration's reference embeddings (weight seed 777) of the first
# 40 corpus sentences and three passages of 30 sentences (cut at 512
# tokens), as f32 bytes
BERT_MODEL_FILE = (68968545, "46dc9cd20a74a6028bf89a9674cfe0e7f1be20b06104"
                             "9a6a39ee71b451fbce68")
BERT_VOCAB = ("07497d7f0fbc17a25bc90641978e5f767757495e81807e5fdd3bc95e34fc"
              "57ac")
TINY_REFERENCE = ("2070aa1ce5a95beb6009bd2c39958446c27f275b2644e15c5da8d8aff"
                  "1131e58")


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def test_bert_model_file_is_unchanged(tmp_path):
    reg = Registry()
    cfg = reg.config("bert_base_q4_0")
    bert = reg.arch("bert")
    w = bert.draw(cfg, 20261018, torch.device("cpu"))
    path, n = bert.write(str(tmp_path), cfg, corpus.load(cfg).vocab, w)
    with open(path, "rb") as f:
        assert (n, _sha(f.read())) == BERT_MODEL_FILE


@pytest.mark.parametrize("config", ["bert_base_q4_0", "minilm_l6_q4_0"])
def test_bert_vocabulary_is_unchanged(config):
    cfg = Registry().config(config)
    assert "architecture" not in cfg
    assert _sha("\n".join(corpus.load(cfg).vocab).encode()) == BERT_VOCAB


def test_bert_reference_is_unchanged():
    cfg = tiny_config()
    corp = corpus.load(cfg)
    tok = corp.tokenizer()
    texts = corp.sentences[:40] + [" ".join(corp.sentences[i:i + 30])
                                   for i in (0, 100, 500)]
    lists = [tok(t, cfg["max_position_embeddings"]) for t in texts]
    bert = Registry().arch("bert")
    cpu = torch.device("cpu")
    emb = bert.Reference(bert.draw(cfg, 777, cpu), cfg, cpu).embed(lists)
    assert emb.dtype == torch.float32 and emb.shape == (43, 64)
    assert _sha(emb.numpy().tobytes()) == TINY_REFERENCE


def test_vocabulary_takes_the_configuration_size():
    plain = corpus.load(tiny_config())
    wide = corpus.load(dict(tiny_config(), vocab_size=50368))
    assert len(plain.vocab) == 30522 and len(wide.vocab) == 50368
    assert len(set(wide.vocab)) == 50368
    assert wide.vocab[:30522] == plain.vocab
    assert wide.tokenizer()("the cat", 512) == plain.tokenizer()("the cat",
                                                                 512)


def test_same_seed_same_inputs():
    a = generate.rng(SEED, generate.TEXTS).integers(1 << 30, size=4)
    b = generate.rng(SEED, generate.TEXTS).integers(1 << 30, size=4)
    assert np.array_equal(a, b)
