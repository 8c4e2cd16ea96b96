"""CLI: load → tokenize → embed one prompt, with timings.

Counterpart of ``bert_tpu/cli.py`` (and of the reference's demo CLI and
parameter parser, examples/main.cpp, bert.cpp:136-193): prints the token
ids, token strings, the embedding vector and load/eval wall times. Flags
mirror the reference surface: ``-m/--model``, ``-p/--prompt``, ``--port``,
``-t/--threads`` (accepted for drop-in compatibility and ignored), plus
``--quantize``, ``--dtype``, ``--pooling``, ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch path) and bert_tpu's
``--dp``/``--tp``: a (data, model) mesh of dp·tp ranks, one process per
rank under torchrun, every rank embedding the prompt and rank 0 printing.

    python -m bert_tpu_torch.cli -m <ggml file | HF dir | .npz> -p "text"
    torchrun --nproc-per-node 2 -m bert_tpu_torch.cli -m <model> --tp 2
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
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel degree (batch rows sharded over the "
                    "mesh's data axis; default 1). dp·tp ranks, launched "
                    "by torchrun")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel degree (Megatron weight sharding "
                    "over the mesh's model axis; default 1)")
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
    if getattr(args, "dp", None) or getattr(args, "tp", None):
        kw = {"dp": args.dp, "tp": args.tp}
    if args.pooling:
        kw["pooling"] = args.pooling
    if max_batch is not None:
        # size the engine's bucket planner to the server's scheduler cap,
        # rounded up to a multiple of dp (an engine invariant)
        dp = getattr(args, "dp", None) or 1
        kw["max_batch"] = -(-max_batch // dp) * dp
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
    # on a mesh every rank embeds the prompt, and rank 0 prints
    say = print
    if model.mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            say = lambda *a, **k: None  # noqa: E731

    tokens = model.tokenize(args.prompt)
    say(f"{len(tokens)} tokens:")
    say(tokens)
    say([model.id_to_token(t) for t in tokens])

    t_tok = time.perf_counter_ns()
    emb = model.encode(args.prompt)  # includes the kernels' first load
    t_first = time.perf_counter_ns()
    emb = model.encode(args.prompt)
    t_eval = time.perf_counter_ns()

    np.set_printoptions(precision=6, suppress=True, threshold=24,
                        edgeitems=8)
    say(f"embedding ({model.n_embd}):")
    say(np.asarray(emb))

    ms = 1e6
    say(f"\ndevice      = {model.device} ({model.compute_dtype})")
    say(f"load time   = {(t_load - t_start) / ms:10.2f} ms")
    say(f"tokenize    = {(t_tok - t_load) / ms:10.2f} ms")
    say(f"first eval  = {(t_first - t_tok) / ms:10.2f} ms "
        f"(includes the kernels' first build/load)")
    say(f"eval time   = {(t_eval - t_first) / ms:10.2f} ms")


if __name__ == "__main__":
    main()
