"""Contrastive fine-tuning: TSV pairs → InfoNCE steps → a weight cache that
``BertTorch.from_file`` (and ``bert_tpu.BertTPU.from_file``) serves.

Counterpart of ``examples/finetune_contrastive.py``, with its arguments,
defaults, batch draws and log lines. Rows of a
``sentence1<TAB>sentence2<TAB>score`` file at or above ``--min-score``
become positive pairs; the other pairs of a batch are the InfoNCE
negatives. Each step draws ``--batch`` pairs from
``np.random.default_rng(0)``, as the JAX example does, so both draw the
same batches from the same model and data.

Usage:
  python -m bert_tpu_torch.finetune -m model-f32.bin \\
      [pairs.tsv] [--steps 100] [--batch 32] [--seq 64] [--lr 2e-5] \\
      [--out tuned.npz] [--ckpt DIR] [--device cuda|cpu] \\
      [--compute-dtype float32|bfloat16]
  torchrun --nproc-per-node N -m bert_tpu_torch.finetune -m ... \\
      --dp D --tp T                     # D·T = N ranks

It trains on the card unless ``--device cpu`` is given, and raises
without one. Training needs DENSE weights (f32/f16 ggml, HF dir, or .npz
cache): INT4-quantized parameters are not differentiable, so quantize
AFTER fine-tuning (``python -m bert_tpu_torch.convert quantize`` on the
converted result). ``--ckpt DIR`` saves the train state there at the end
and resumes from it when it exists, in the port's own format
(bert_tpu_torch/checkpoint.py), not bert_tpu's orbax directories.
``--dp``/``--tp`` train over a (data, model) mesh of dp·tp ranks
(``train.make_sharded_train_step``), one process per rank under
torchrun; rank 0 prints and writes the ``.npz``, and a train state
saved at one (dp, tp) resumes at any other.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def read_sts_pairs(path: str) -> Tuple[List[str], List[str], np.ndarray]:
    """``sentence1<TAB>sentence2<TAB>score`` lines → (s1, s2, scores);
    lines with fewer fields are skipped (benchmarks/eval_common.py)."""
    s1, s2, gold = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            s1.append(parts[0])
            s2.append(parts[1])
            gold.append(float(parts[2]))
    if not gold:
        raise ValueError(f"no pairs parsed from {path}")
    return s1, s2, np.asarray(gold)


def pad_batch(token_lists, seq):
    ids = np.zeros((len(token_lists), seq), np.int32)
    mask = np.zeros((len(token_lists), seq), np.float32)
    for i, t in enumerate(token_lists):
        t = t[:seq]
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1.0
    return ids, mask


def draw_batches(toks_a, toks_b, steps: int, batch: int, seq: int):
    """Yield ``steps`` batches {ids_a, mask_a, ids_b, mask_b} of
    ``min(batch, n)`` pairs each, drawn without replacement from
    ``np.random.default_rng(0)`` as the JAX example draws them."""
    rng = np.random.default_rng(0)
    n = len(toks_a)
    for _ in range(steps):
        pick = rng.choice(n, size=min(batch, n), replace=False)
        out = {}
        for side, toks in (("a", toks_a), ("b", toks_b)):
            ids, mask = pad_batch([toks[i] for i in pick], seq)
            out[f"ids_{side}"], out[f"mask_{side}"] = ids, mask
        yield out


def main(argv=None) -> dict:
    """Returns {"first_loss", "last_loss", "out"}, and each step's
    "losses", "grad_norms" and "step_ms" (host clock around the step and
    the read of its loss, which waits for the device)."""
    ap = argparse.ArgumentParser(prog="python -m bert_tpu_torch.finetune")
    ap.add_argument("-m", "--model", required=True,
                    help="dense model: f32/f16 ggml-bin, HF dir, .npz cache")
    ap.add_argument("pairs", nargs="?",
                    default=os.path.join(REPO, "benchmarks", "data",
                                         "sts_en.tsv"))
    ap.add_argument("--min-score", type=float, default=3.5,
                    help="pairs scoring >= this are positives (STSB 0-5)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--temperature", type=float, default=0.05)
    ap.add_argument("--out", default="tuned.npz",
                    help=".npz weight cache loadable by BertTorch.from_file")
    ap.add_argument("--ckpt", default=None,
                    help="train-state dir (resume with --ckpt later)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=sorted(_DTYPES))
    ap.add_argument("--dp", type=int, default=0)
    ap.add_argument("--tp", type=int, default=0)
    args = ap.parse_args(argv)

    from .checkpoint import load_train_state, save_params, save_train_state
    from .engine import resolve_device
    from .loader import load_model
    from .model import TrainableBertModel
    from .params import params_to_numpy, params_to_torch
    from .quant import QuantTensor
    from .tokenizer import WordPieceTokenizer
    from .parallel.mesh import make_mesh
    from .train import (init_train_state, make_optimizer,
                        make_sharded_train_step, make_train_step)

    device = resolve_device(args.device)
    mesh = None
    if args.dp or args.tp:
        dp, tp = max(1, args.dp), max(1, args.tp)
        mesh = make_mesh(dp * tp, tp=tp, device_type=device.type)
    # on a mesh every rank runs this program; rank 0 speaks and writes
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    loaded = load_model(args.model)
    if any(isinstance(v, QuantTensor)
           for sub in loaded.params.values() for v in sub.values()):
        sys.exit("model has INT4-quantized weights — fine-tune the dense "
                 "f32/f16 file and quantize the result instead")
    pooling = loaded.pooling or "mean"

    s1, s2, gold = read_sts_pairs(args.pairs)
    keep = [i for i, g in enumerate(gold) if g >= args.min_score]
    if len(keep) < 2:
        sys.exit(f"only {len(keep)} pairs score >= {args.min_score}")
    say(f"{len(keep)} positive pairs (of {len(gold)}) from {args.pairs}")
    tokenizer = WordPieceTokenizer(loaded.vocab)
    tok = lambda texts: [tokenizer.tokenize(t, args.seq) for t in texts]
    toks_a, toks_b = tok([s1[i] for i in keep]), tok([s2[i] for i in keep])

    opt = make_optimizer(args.lr)
    # on a mesh the whole state is built on the host, and
    # make_sharded_train_step places each rank's shard of it
    model = TrainableBertModel(
        params_to_torch(loaded.params,
                        device="cpu" if mesh is not None else device),
        loaded.config)
    state = init_train_state(model, opt)
    if args.ckpt and os.path.isdir(args.ckpt):
        state = load_train_state(args.ckpt, state)
        say(f"resumed from {args.ckpt} at step {int(state.step)}")
    kw = dict(temperature=args.temperature,
              compute_dtype=_DTYPES[args.compute_dtype], pooling=pooling)
    if mesh is not None:
        state, step_fn = make_sharded_train_step(mesh, loaded.config, opt,
                                                 state, **kw)
        say(f"sharded step over mesh (data={dp}, model={tp})")
    else:
        step_fn = make_train_step(loaded.config, opt, **kw)

    losses, grad_norms, step_ms = [], [], []
    t0 = time.time()
    for it, batch in enumerate(draw_batches(toks_a, toks_b, args.steps,
                                            args.batch, args.seq)):
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if it % max(1, args.steps // 10) == 0 or it == args.steps - 1:
            say(f"step {int(state.step):4d}  loss {loss:.4f}  "
                  f"grad_norm {grad_norms[-1]:.3f}")
    dt = time.time() - t0
    say(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * min(args.batch, len(keep)) / dt:.0f} pairs/s); "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}")

    if args.ckpt:
        save_train_state(args.ckpt, state)
        say(f"train state → {args.ckpt}")
    tuned = params_to_numpy(state.params)  # gathered whole on a mesh
    if rank0:
        save_params(args.out, tuned, loaded.config, loaded.vocab.tokens,
                    pooling=pooling)
    say(f"weights → {args.out}  "
          f"(serve with BertTorch.from_file({args.out!r}))")
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "out": args.out, "losses": losses, "grad_norms": grad_norms,
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
