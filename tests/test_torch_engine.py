"""BertTorch end to end on the CPU, against BertTPU; and the port's rules.

The fixture is a Q4_0 ggml file built as bench.py builds its model files
(MiniLM-L6 widths, fixture vocab, seeded weights), cut to 2 layers. Both
engines load it at f32 on the CPU and embed a mixed-length corpus that
takes both routes: short sentences packed several per row, sentences over
64 tokens padded into length buckets. Tolerance 1e-5: the same f32
arithmetic, summed in another order.

A second fixture is an HF checkpoint directory at d_head 26
(tests/test_torch_loader.py writes it), whose attention takes the
per-(batch, head) route; on it the streaming, warmup-manifest and
weight-cache surfaces are checked against the bulk path.

The port must import neither JAX nor anything of bert_tpu (the machine
with the card has no JAX), and its entry points must run on the card
unless the caller asks for the CPU.
"""

import ast
import json
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
from bert_tpu_torch.ops.attention import multi_head_attention
from bert_tpu_torch.ops.fused_attention import fused_qkv_attention
from bert_tpu_torch.ops.layer_norm import fused_layer_norm
from bert_tpu_torch.ops.q4_matmul import q4_matmul
from fixture_vocab import GOLDEN_CASES, KNOWN_TOKENS, build_fixture_tokens
from test_torch_loader import HF_SMALL, write_hf_dir

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
    counters = (q4_matmul, fused_layer_norm, fused_qkv_attention,
                multi_head_attention)
    for fn in counters:
        fn.launches = 0
    port_cpu.encode_batch(corpus)
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]


def test_from_file_defaults_to_cuda_and_raises_without_it(model_file,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertTorch.from_file(model_file)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_unported_formats_raise(tmp_path):
    """HF directories and .npz caches load now (test_torch_loader.py);
    what the port still cannot read raises with the reason."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        load_model(str(tmp_path))  # not a checkpoint directory
    path = write_hf_dir(tmp_path / "hf", fmt="safetensors")
    st = os.path.join(path, "model.safetensors")
    with open(st, "rb") as f:  # relabel one F32 tensor as BF16
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        rest = f.read()
    header["embeddings.LayerNorm.bias"]["dtype"] = "BF16"
    header["embeddings.LayerNorm.bias"]["shape"] = [2 * HF_SMALL["n_embd"]]
    raw = json.dumps(header).encode()
    with open(st, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + rest)
    with pytest.raises(ValueError, match="BF16"):
        load_model(path)


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


# what the port never imports: JAX and its optimizer/checkpoint libraries,
# and the JAX package and its benchmark scripts
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "bert_tpu", "benchmarks")


def test_port_imports_neither_jax_nor_bert_tpu():
    mods = _port_modules()
    assert {"bert_tpu_torch.engine", "bert_tpu_torch.server",
            "bert_tpu_torch.cli", "bert_tpu_torch.checkpoint",
            "bert_tpu_torch.ops.attention",
            "bert_tpu_torch.ops.int8_matmul", "bert_tpu_torch.convert",
            "bert_tpu_torch.formats.safetensors", "bert_tpu_torch.train",
            "bert_tpu_torch.finetune", "bert_tpu_torch.profiling",
            "bert_tpu_torch.testing", "bert_tpu_torch.parallel",
            "bert_tpu_torch.parallel.mesh", "bert_tpu_torch.parallel.sharding",
            "bert_tpu_torch.parallel.spmd",
            "bert_tpu_torch.parallel.multihost",
            "bert_tpu_torch.parallel.collectives"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
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
                assert top not in FORBIDDEN, f"{path} imports {n}"


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


# -- the d_head 26 HF directory: the per-(batch, head) route ----------------

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return write_hf_dir(tmp_path_factory.mktemp("hf") / "rubert_small",
                        fmt="bin", pooling="cls")


@pytest.fixture(scope="module")
def hf_corpus(corpus):
    words = sorted(w for w in KNOWN_TOKENS
                   if w.isalpha() and len(w) > 1 and not w.startswith("["))
    rng = np.random.default_rng(1)
    # one sentence past n_max_tokens = 256, truncated into the 256 bucket
    return corpus + [" ".join(rng.choice(words, size=300))]


@pytest.fixture(scope="module")
def hf_port(hf_dir):
    return BertTorch.from_file(hf_dir, device="cpu")


def test_hf_dir_matches_bert_tpu(hf_dir, hf_corpus, hf_port):
    assert hf_port.config.d_head == 26 and hf_port.pooling == "cls"
    got = hf_port.encode_batch(hf_corpus)
    ref = BertTPU.from_file(hf_dir).encode_batch(hf_corpus)
    assert got.shape == (len(hf_corpus), HF_SMALL["n_embd"])
    np.testing.assert_allclose(got, ref, atol=1e-5)
    buckets = hf_port.stats()["buckets"]
    assert any(k.endswith("packed") for k in buckets)
    assert any(k.endswith("x256") for k in buckets)  # the truncated one


@pytest.mark.parametrize("window,depth", [(7, 2), (4096, 4), (1, 1)])
def test_encode_iter_matches_encode_batch(hf_port, hf_corpus, window, depth):
    bulk = hf_port.encode_batch(hf_corpus)
    blocks = list(hf_port.encode_iter(hf_corpus, window=window, depth=depth))
    assert [len(b) for b in blocks][:-1] == [window] * (len(blocks) - 1)
    np.testing.assert_allclose(np.concatenate(blocks), bulk, atol=1e-6)
    toks = [hf_port.tokenize(t) for t in hf_corpus]
    streamed = np.concatenate(list(hf_port.eval_tokens_iter(
        toks, window=window, depth=depth)))
    np.testing.assert_allclose(streamed, bulk, atol=1e-6)
    with pytest.raises(ValueError, match="window"):
        hf_port.encode_iter(hf_corpus, window=0)
    with pytest.raises(ValueError, match="depth"):
        hf_port.eval_tokens_iter(toks, depth=0)


def test_warmup_manifest_roundtrip(hf_dir, hf_corpus, tmp_path):
    eng = BertTorch.from_file(hf_dir, device="cpu", max_batch=16)
    eng.encode_batch(hf_corpus)
    seen = eng.seen_shapes()
    assert {s["kind"] for s in seen} == {"packed", "bucketed"}
    path = str(tmp_path / "manifest.json")
    eng.save_warmup_manifest(path)
    with open(path) as f:
        data = json.load(f)
    assert data["model"] == {"n_embd": 52, "n_layer": 2}
    assert data["shapes"] == seen
    fresh = BertTorch.from_file(hf_dir, device="cpu", max_batch=16)
    want = sorted((s["rows"], s["seq"], s["kind"]) for s in seen)
    assert fresh._load_manifest_shapes(path) == want
    fresh.warmup(manifest=path)  # runs exactly those shapes
    assert fresh.stats()["sentences"] == 0  # warmup serves nobody
    # merge on save, and survive a corrupt or foreign manifest
    fresh.encode_batch(["going to the store"])
    fresh.save_warmup_manifest(path)
    with open(path) as f:
        assert len(json.load(f)["shapes"]) == len(seen)  # 8x64 packed seen
    with open(path, "w") as f:
        f.write("{ truncated")
    assert fresh._load_manifest_shapes(path) == []
    with open(path, "w") as f:
        json.dump({"model": {"n_embd": 384, "n_layer": 6},
                   "shapes": data["shapes"]}, f)
    assert fresh._load_manifest_shapes(path) == []
    shapes = [{"rows": 999, "seq": 100}, {"rows": 8, "seq": 30,
                                          "kind": "packed"},
              {"rows": 1, "seq": 10_000}, {"rows": 0, "seq": 16}]
    assert fresh._load_manifest_shapes(shapes) == [(8, 64, "packed"),
                                                   (16, 128, "bucketed")]
    fresh.warmup(batch_sizes=[1, 40], max_rows=8)  # the grid


def test_save_cache_reloads_the_same_model(hf_port, hf_corpus, tmp_path):
    path = str(tmp_path / "cache.npz")
    hf_port.save_cache(path)
    cached = BertTorch.from_file(path, device="cpu")
    assert cached.pooling == "cls" and cached.config == hf_port.config
    assert "parse" in cached.stats()["load_phases"]
    np.testing.assert_array_equal(cached.encode_batch(hf_corpus),
                                  hf_port.encode_batch(hf_corpus))
    # bert_tpu reads the port's cache
    np.testing.assert_allclose(BertTPU.from_file(path).encode_batch(
        hf_corpus[:5]), hf_port.encode_batch(hf_corpus[:5]), atol=1e-5)
