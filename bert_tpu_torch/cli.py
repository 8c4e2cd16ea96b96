"""CLI: load → tokenize → embed one prompt, with timings.

Counterpart of ``bert_tpu/cli.py`` (and of the reference's demo CLI and
parameter parser, examples/main.cpp, bert.cpp:136-193): prints the token
ids, token strings, the embedding vector and load/eval wall times. Flags
mirror the reference surface: ``-m/--model``, ``-p/--prompt``, ``--port``,
``-t/--threads`` (accepted for drop-in compatibility and ignored), plus
``--quantize``, ``--dtype``, ``--pooling`` and ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path). Data and tensor
parallelism (bert_tpu's ``--dp``/``--tp``) are not ported yet (ROADMAP.md).

    python -m bert_tpu_torch.cli -m <ggml file | HF dir | .npz> -p "text"
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-m", "--model", required=True,
                    help="ggml-bin model file, HF checkpoint dir or .npz "
                    "weight cache")
    ap.add_argument("-t", "--threads", type=int, default=6,
                    help="(compat) CPU threads; ignored")
    ap.add_argument("--port", type=int, default=8085,
                    help="server port (server mode only)")
    ap.add_argument("--quantize", choices=["q4_0", "q4_1"], default=None,
                    help="quantize on load (dense checkpoints only)")
    ap.add_argument("--dtype", choices=["bf16", "f32"], default=None,
                    help="activation compute dtype (default: bf16 on CUDA, "
                    "f32 on the CPU)")
    ap.add_argument("--pooling", choices=["mean", "cls"], default=None,
                    help="sentence pooling: mean (sentence-transformers "
                    "models) or cls (BGE-family checkpoints). Default: what "
                    "the checkpoint declares (HF dirs), else mean")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                    "PyTorch path)")


def load_model_from_args(args, max_batch=None):
    import torch

    from .engine import BertTorch
    from .quant import FTYPE_BY_NAME

    qft = FTYPE_BY_NAME[args.quantize] if args.quantize else None
    dtype = {None: None, "bf16": torch.bfloat16,
             "f32": torch.float32}[args.dtype]
    kw = {}
    if args.pooling:
        kw["pooling"] = args.pooling
    if max_batch is not None:
        # size the engine's bucket planner to the server's scheduler cap
        kw["max_batch"] = max_batch
    return BertTorch.from_file(args.model, device=args.device,
                               quantize_ftype=qft, compute_dtype=dtype, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        "bert_tpu_torch.cli", description="embed one prompt and print it")
    add_common_args(ap)
    ap.add_argument("-p", "--prompt", default="Hello world",
                    help="prompt to embed")
    args = ap.parse_args(argv)

    t_start = time.perf_counter_ns()
    model = load_model_from_args(args)
    t_load = time.perf_counter_ns()

    tokens = model.tokenize(args.prompt)
    print(f"{len(tokens)} tokens:")
    print(tokens)
    print([model.id_to_token(t) for t in tokens])

    t_tok = time.perf_counter_ns()
    emb = model.encode(args.prompt)  # includes the kernels' first load
    t_first = time.perf_counter_ns()
    emb = model.encode(args.prompt)
    t_eval = time.perf_counter_ns()

    np.set_printoptions(precision=6, suppress=True, threshold=24,
                        edgeitems=8)
    print(f"embedding ({model.n_embd}):")
    print(np.asarray(emb))

    ms = 1e6
    print(f"\ndevice      = {model.device} ({model.compute_dtype})")
    print(f"load time   = {(t_load - t_start) / ms:10.2f} ms")
    print(f"tokenize    = {(t_tok - t_load) / ms:10.2f} ms")
    print(f"first eval  = {(t_first - t_tok) / ms:10.2f} ms "
          f"(includes the kernels' first build/load)")
    print(f"eval time   = {(t_eval - t_first) / ms:10.2f} ms")


if __name__ == "__main__":
    main()
