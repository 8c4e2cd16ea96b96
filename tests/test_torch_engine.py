"""BertTorch end to end on the CPU, against BertTPU; and the port's rules.

The fixture is a Q4_0 ggml file built as bench.py builds its model files
(MiniLM-L6 widths, fixture vocab, seeded weights), cut to 2 layers. Both
engines load it at f32 on the CPU and embed a mixed-length corpus that
takes both routes: short sentences packed several per row, sentences over
64 tokens padded into length buckets. Tolerance 1e-5: the same f32
arithmetic, summed in another order.

The port must import neither JAX nor anything of bert_tpu (the machine
with the card has no JAX), and its entry points must run on the card
unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert_tpu import BertTPU
from bert_tpu.formats import GgmlHParams, write_ggml
from bert_tpu.params import BertConfig, random_named_tensors
from bert_tpu_torch import BertTorch, Vocab, WordPieceTokenizer
from bert_tpu_torch.engine import resolve_device
from bert_tpu_torch.loader import load_model
from bert_tpu_torch.ops.fused_attention import fused_qkv_attention
from bert_tpu_torch.ops.layer_norm import fused_layer_norm
from bert_tpu_torch.ops.q4_matmul import q4_matmul
from fixture_vocab import GOLDEN_CASES, KNOWN_TOKENS, build_fixture_tokens

# One intra-op thread: the suite runs several test files at once, and
# torch's default pool (one thread per core, in every worker) starves
# the timing-sensitive tests running beside these.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bert_tpu_torch")


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    cfg = BertConfig(n_vocab=30522, n_max_tokens=512, n_embd=384,
                     n_intermediate=1536, n_head=12, n_layer=2)
    hp = GgmlHParams(cfg.n_vocab, cfg.n_max_tokens, cfg.n_embd,
                     cfg.n_intermediate, cfg.n_head, cfg.n_layer, ftype=2)
    path = str(tmp_path_factory.mktemp("ggml") / "minilm_2l_q4_0.bin")
    write_ggml(path, hp, build_fixture_tokens(), random_named_tensors(cfg, 0))
    return path


@pytest.fixture(scope="module")
def corpus():
    words = sorted(w for w in KNOWN_TOKENS
                   if w.isalpha() and len(w) > 1 and not w.startswith("["))
    rng = np.random.default_rng(0)
    short = [" ".join(rng.choice(words, size=int(n)))
             for n in rng.integers(3, 25, size=20)]
    long = [" ".join(rng.choice(words, size=int(n)))
            for n in (70, 90, 130)]
    return short + long + ["", "Québec"]


@pytest.fixture(scope="module")
def port_cpu(model_file):
    return BertTorch.from_file(model_file, device="cpu")


def test_encode_batch_matches_bert_tpu(model_file, corpus, port_cpu):
    lengths = [len(port_cpu.tokenize(s)) for s in corpus]
    assert sum(n > 64 for n in lengths) == 3 and min(lengths) <= 64
    got = port_cpu.encode_batch(corpus)
    ref = BertTPU.from_file(model_file).encode_batch(corpus)
    assert got.shape == (len(corpus), 384) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    buckets = port_cpu.stats()["buckets"]
    assert any(k.endswith("packed") for k in buckets)  # short → packed
    assert any(not k.endswith("packed") for k in buckets)  # long → bucketed
    np.testing.assert_allclose(port_cpu.encode(corpus[3]), got[3], atol=1e-5)


def test_engine_defaults_and_stats(port_cpu):
    assert port_cpu.device.type == "cpu"
    assert port_cpu.compute_dtype == torch.float32
    assert port_cpu.wire_dtype == "f32"
    assert port_cpu.n_embd == 384 and port_cpu.n_max_tokens == 512
    assert port_cpu.id_to_token(101) == "[CLS]"
    phases = port_cpu.stats()["load_phases"]
    assert set(phases) >= {"parse", "emb_dequant", "repack", "to_device"}


@pytest.mark.parametrize("wire,tol", [("f16", 2e-3), ("int8", 2e-2)])
def test_wire_dtypes(model_file, corpus, port_cpu, wire, tol):
    exact = port_cpu.encode_batch(corpus)
    got = BertTorch.from_file(model_file, device="cpu",
                              wire_dtype=wire).encode_batch(corpus)
    np.testing.assert_allclose(got, exact, atol=tol)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=tol)


def test_kernel_counters_stay_zero_on_cpu(port_cpu, corpus):
    for fn in (q4_matmul, fused_layer_norm, fused_qkv_attention):
        fn.launches = 0
    port_cpu.encode_batch(corpus)
    assert (q4_matmul.launches, fused_layer_norm.launches,
            fused_qkv_attention.launches) == (0, 0, 0)


def test_from_file_defaults_to_cuda_and_raises_without_it(model_file,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertTorch.from_file(model_file)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_unported_formats_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model(str(tmp_path / "cache.npz"))


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("case", range(len(GOLDEN_CASES)))
def test_tokenizer_goldens(case, use_native):
    text, expected = GOLDEN_CASES[case]
    tok = WordPieceTokenizer(Vocab.from_tokens(build_fixture_tokens()),
                             warn_unknown=False, use_native=use_native)
    assert (tok._native is None) == (use_native is False)
    assert tok.tokenize(text) == expected
    assert tok.tokenize_batch([text, text], 512) == [expected, expected]


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return mods


def test_port_imports_neither_jax_nor_bert_tpu():
    mods = _port_modules()
    assert "bert_tpu_torch.engine" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'bert_tpu' "
        "or m.startswith('bert_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_have_no_jax_or_bert_tpu_imports():
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, *m.split(".")) + (
            "/__init__.py" if os.path.isdir(os.path.join(REPO, *m.split(".")))
            else ".py") for m in _port_modules()]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "bert_tpu"), \
                    f"{path} imports {n}"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result, both
    in the checkout and in a directory holding only the script."""
    lonely = tmp_path / "chip_smoke.py"
    lonely.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), str(lonely))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
