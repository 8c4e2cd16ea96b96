"""The port's conversion entry points and ``load_tokenizer`` on the CPU,
against bert_tpu's.

An HF checkpoint directory (random weights from a seed, with the pooler
and ``position_ids`` a real checkpoint carries, written by the port tests'
own ``write_hf_dir``) goes through ``convert_hf_to_ggml`` at f32 and f16
and ``quantize_ggml`` at Q4_0 and Q4_1 in both packages: every output
file is byte for byte bert_tpu's, and so are the log lines. The two
``python -m bert_tpu_torch.convert`` subcommands run as subprocesses, as
tools/convert_hf.py and tools/quantize.py are run.
"""

import os
import subprocess
import sys

import pytest
import torch

from bert_tpu import convert as jconvert
from bert_tpu import load_tokenizer as j_load_tokenizer
from bert_tpu_torch import convert as tconvert
from bert_tpu_torch import load_tokenizer
from bert_tpu_torch.quant import nibble_histogram
from fixture_vocab import GOLDEN_CASES
from test_torch_loader import write_hf_dir

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# D and F multiples of 64, as Q4 needs; the full fixture vocab
HF_Q4 = dict(n_vocab=30522, n_max_tokens=128, n_embd=64,
             n_intermediate=128, n_head=2, n_layer=2)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("hf") / "model", HF_Q4,
                        seed=3, pooling="mean")


@pytest.mark.parametrize("ftype", [0, 1], ids=["f32", "f16"])
def test_convert_hf_matches_bert_tpu(hf_dir, tmp_path, ftype):
    got = tconvert.convert_hf_to_ggml(hf_dir, str(tmp_path / "port.bin"),
                                      ftype=ftype)
    want = jconvert.convert_hf_to_ggml(hf_dir, str(tmp_path / "jax.bin"),
                                       ftype=ftype)
    assert _bytes(got) == _bytes(want)


def test_convert_warns_of_cls_pooling_as_bert_tpu(tmp_path, capsys):
    d = write_hf_dir(tmp_path / "cls", HF_Q4, seed=4, pooling="cls")
    tconvert.convert_hf_to_ggml(d, str(tmp_path / "port.bin"))
    got = capsys.readouterr().err
    jconvert.convert_hf_to_ggml(d, str(tmp_path / "jax.bin"))
    assert "declares CLS pooling" in got and got == capsys.readouterr().err


@pytest.fixture(scope="module")
def f32_file(hf_dir, tmp_path_factory):
    return tconvert.convert_hf_to_ggml(
        hf_dir, str(tmp_path_factory.mktemp("f32") / "m-f32.bin"), ftype=0)


@pytest.mark.parametrize("ftype", [2, 3], ids=["q4_0", "q4_1"])
def test_quantize_ggml_matches_bert_tpu(f32_file, tmp_path, ftype):
    got_log, want_log = [], []
    got = tconvert.quantize_ggml(f32_file, str(tmp_path / "port.bin"),
                                 ftype, log=got_log.append)
    want = jconvert.quantize_ggml(f32_file, str(tmp_path / "jax.bin"),
                                  ftype, log=want_log.append)
    assert got == want
    assert _bytes(tmp_path / "port.bin") == _bytes(tmp_path / "jax.bin")
    assert got_log == want_log
    assert any("→ q4_" in line for line in got_log)
    assert got_log[-2].startswith("global code histogram: ")


def test_quantize_refuses_a_quantized_source(f32_file, tmp_path):
    q = str(tmp_path / "q4.bin")
    tconvert.quantize_ggml(f32_file, q, 2, log=lambda _: None)
    with pytest.raises(ValueError, match="source must be f32/f16, got q4_0"):
        tconvert.quantize_ggml(q, str(tmp_path / "again.bin"), 3)


def test_nibble_histogram():
    import numpy as np

    codes = np.array([[0, 1, 1, 15], [15, 15, 7, 0]], np.uint8)
    assert nibble_histogram(codes).tolist() == [
        2, 2, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 3]


def _run(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "bert_tpu_torch.convert",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_convert_cli_subcommands(hf_dir, f32_file, tmp_path):
    """``hf <dir> [0|1]`` writes <dir>/ggml-model-f16.bin (as
    tools/convert_hf.py does); ``quantize <in> <out> q4_0`` writes Q4_0;
    both byte for byte bert_tpu's."""
    r = _run("hf", hf_dir, "1")
    assert r.returncode == 0, r.stderr
    out = os.path.join(hf_dir, "ggml-model-f16.bin")
    assert r.stdout.strip() == f"Done. Output file: {out}"
    want = jconvert.convert_hf_to_ggml(hf_dir, str(tmp_path / "jax16.bin"))
    assert _bytes(out) == _bytes(want)
    os.remove(out)

    q = str(tmp_path / "cli_q4_0.bin")
    r = _run("quantize", f32_file, q, "q4_0")
    assert r.returncode == 0, r.stderr
    assert "global code histogram: " in r.stdout
    jconvert.quantize_ggml(f32_file, str(tmp_path / "jax_q4.bin"), 2,
                           log=lambda _: None)
    assert _bytes(q) == _bytes(tmp_path / "jax_q4.bin")


@pytest.mark.parametrize("args, message", [
    (["hf", "no-such-model"], "does not download"),
    (["hf", "."], "invalid ftype"),
    (["quantize", "a.bin", "b.bin", "f16"], "type must be 2 (q4_0) or 3"),
    (["quantize", "a.bin", "b.bin", "q8"], "invalid type 'q8'"),
    (["nothing"], "Entry points"),
])
def test_convert_cli_refuses(args, message, tmp_path):
    if args[:2] == ["hf", "."]:
        args = ["hf", str(tmp_path), "7"]
    r = _run(*args, cwd=str(tmp_path))
    assert r.returncode != 0 and message in r.stderr, r.stderr


def test_load_tokenizer_matches_bert_tpu(hf_dir):
    vocab_txt = os.path.join(hf_dir, "vocab.txt")
    tok, jtok = load_tokenizer(vocab_txt), j_load_tokenizer(vocab_txt)
    for text, expected in GOLDEN_CASES:
        assert tok.tokenize(text, 512) == jtok.tokenize(text, 512)
        assert tok.tokenize(text, 512) == expected
