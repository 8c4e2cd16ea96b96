"""One run of one benchmark cell of ``bert_tpu_torch`` on the card.

    python3 -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>

It reads ``BENCHMARK.json`` at the checkout's root, finds the cell's
configuration, traffic mix, limits and metrics by name, and the
configuration's architecture (``architecture``, else ``bert``) by its name
(registry.py), draws the weights and the traffic from the seed, sets up the
program (``bert_tpu_torch.BertTorch.from_file`` on the model file the
architecture writes, and the shapes its traffic uses), measures for
``--seconds`` seconds, frees the program, checks what the timed path
produced against the architecture's plain reference, and prints one JSON
line last on standard output. With
``--trace 1`` it reports the cell's per-layer metrics from a device trace
of the window instead of its end-to-end metrics.

It exits with another code than 0 and prints no result where no CUDA card
is present, where the cell asks for more cards than there are, and where
the process holds ``jax``, ``jaxlib``, ``flax`` or ``bert_tpu`` once the
window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import corpus as corpus_mod
from . import generate
from .registry import (CHECKOUT, Registry, load_benchmark, metrics_for,
                       workload)

# stands for a number that could not be read (JSON has no infinity)
NO_NUMBER = 1e9
FORBIDDEN = ("jax", "jaxlib", "flax", "bert_tpu")
# the architecture of a configuration that names none
DEFAULT_ARCH = "bert"
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}


def process_start() -> float:
    """The monotonic time at which this process started (Linux), else
    now."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot_now = time.clock_gettime(time.CLOCK_BOOTTIME)
        age = boot_now - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


@dataclass
class Cell:
    """Everything one run of a cell needs, and what it learns."""
    name: str
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object                      # torch.device
    t_start: float                      # process start, monotonic
    engine_overrides: dict = field(default_factory=dict)
    # set by the run
    arch: object = None                 # the architecture's module
    corpus: object = None
    t_window: Optional[float] = None    # monotonic start of the window
    notes: Dict[str, object] = field(default_factory=dict)
    # test hooks: applied to the engine after set-up (a planted fault)
    engine_hook: Optional[Callable] = None
    # an engine already set up for this cell's configuration and seed
    # (sweep.py runs several rates on one)
    engine: object = None

    @property
    def cap(self) -> int:
        return self.cfg["max_position_embeddings"]

    def weight_seed(self) -> int:
        return int(generate.rng(self.seed, generate.WEIGHTS).integers(
            2 ** 62))


def engine_kwargs(cell: Cell) -> dict:
    import torch

    kw = dict(cell.cfg["engine"])
    kw.update(cell.engine_overrides)
    if "compute_dtype" in kw:
        kw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    return kw


def build_engine(cell: Cell):
    """Draw the weights on the device, write them as the architecture's
    model file under TMPDIR, and load it through the user's entry."""
    import torch
    from bert_tpu_torch import BertTorch

    if cell.engine is not None:
        return cell.engine
    t = time.monotonic()
    w = cell.arch.draw(cell.cfg, cell.weight_seed(), cell.device)
    with tempfile.TemporaryDirectory(prefix="gpubench-") as d:
        path, cell.notes["model_file_bytes"] = cell.arch.write(
            d, cell.cfg, cell.corpus.vocab, w)
        del w
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(cell.device)
        t_load = time.monotonic()
        engine = BertTorch.from_file(path, device=cell.device,
                                     **engine_kwargs(cell))
    cell.notes["setup_phases_s"] = {
        "start_to_draw": t - cell.t_start, "draw_and_file": t_load - t,
        "from_file": time.monotonic() - t_load,
        "load_phases": engine.stats()["load_phases"]}
    if cell.engine_hook is not None:
        cell.engine_hook(engine)
    return engine


def warm_up(cell: Cell, engine, run_call: Callable, calls: List,
            min_calls: int, stable_calls: int) -> None:
    """Run the traffic's own warm-up calls until the shapes the engine has
    executed stop growing, then capture the rest of the batch-size ladder
    of every sequence length met, so that no shape first appears inside
    the window."""
    from bert_tpu_torch.batching import size_bucket

    seen, stable, i = -1, 0, -1
    for i, call in enumerate(calls):
        run_call(call)
        n = len(engine.seen_shapes())
        stable = stable + 1 if n == seen else 0
        seen = n
        if i + 1 >= min_calls and stable >= stable_calls:
            break
    cell.notes["warm_calls"] = i + 1
    shapes = engine.seen_shapes()
    ladder = sorted({size_bucket(r, 1) for r in range(1, engine.max_batch
                                                      + 1)})
    extra = [{"rows": r, "seq": s, "kind": "bucketed"}
             for s in sorted({sh["seq"] for sh in shapes
                              if sh["kind"] == "bucketed"})
             for r in ladder]
    extra += [{"rows": r, "seq": s, "kind": "packed"}
              for s in sorted({sh["seq"] for sh in shapes
                               if sh["kind"] == "packed"})
              for r in sorted({min(size_bucket(r, 8), engine.max_batch)
                               for r in range(1, engine.max_batch + 1)})]
    if extra:
        engine.warmup(manifest=extra)
    cell.notes["programs_after_warmup"] = n_programs(engine)


def n_programs(engine) -> int:
    """The engine's captured programs (its table has no public reader): a
    note of what the warm-up captured, and a check that the window
    captured nothing."""
    programs = getattr(engine, "_programs", None)
    return len(programs.table) if programs is not None else 0


def memory_peak(cell: Cell) -> int:
    import torch

    if cell.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(cell.device))


def free(cell: Cell) -> None:
    import torch

    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
        torch.cuda.empty_cache()


def compare(cell: Cell, answers: List[Tuple[str, np.ndarray]]
            ) -> Dict[str, float]:
    """The plain reference over the answers' texts; the widest L2 gap
    between an answer and the reference's embedding of its text."""
    if not answers:
        return {"emb_gap_max": NO_NUMBER, "compared": 0}
    emb = reference_embeddings(cell, [text for text, _ in answers])
    prog = np.stack([a for _, a in answers]).astype(np.float64)
    gaps = np.linalg.norm(prog - emb, axis=1)
    if not np.all(np.isfinite(gaps)):
        return {"emb_gap_max": NO_NUMBER, "compared": len(answers)}
    return {"emb_gap_max": float(gaps.max()), "compared": len(answers),
            "emb_gap_median": float(np.median(gaps))}


def reference_embeddings(cell: Cell, texts: List[str],
                         precision: str = "f32") -> np.ndarray:
    """The architecture's plain reference's embeddings of ``texts``, from
    its own tokenizer and its own reading of the seed's weights."""
    ref = cell.arch.Reference(
        cell.arch.draw(cell.cfg, cell.weight_seed(), cell.device), cell.cfg,
        cell.device, precision=precision)
    tok = cell.corpus.tokenizer()
    emb = ref.embed([tok(text, cell.cap) for text in texts])
    out = emb.cpu().numpy().astype(np.float64)
    del ref, emb
    free(cell)
    return out


def judge(readings: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number compared beside its limit."""
    return {name: {"value": readings[name], "limit": lim["limit"]}
            for name, lim in limits["checks"].items()}


def loop(mix: dict):
    if mix["loop"] == "bulk":
        from .loops import bulk
        return bulk
    if mix["loop"] == "serve":
        from .loops import serve
        return serve
    raise ValueError(f"unknown loop {mix['loop']!r}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def make_cell(bench: dict, name: str, seed: int, seconds: float,
              trace: bool, device, registry: Registry, t_start: float,
              engine_overrides: Optional[dict] = None,
              mix_overrides: Optional[dict] = None, **kw) -> Cell:
    import torch

    w = workload(bench, name)
    mix = dict(registry.traffic(w["traffic"]), **(mix_overrides or {}))
    cfg = registry.config(w["config"])
    cell = Cell(name=name, cfg=cfg, mix=mix,
                limits=registry.limits(name), seed=seed, seconds=seconds,
                trace=trace, device=torch.device(device), t_start=t_start,
                engine_overrides=engine_overrides or {},
                **kw)
    cell.arch = registry.arch(cfg.get("architecture", DEFAULT_ARCH))
    cell.corpus = corpus_mod.load(cfg)
    return cell


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool,
            device, registry: Registry, t_start: float,
            engine_overrides: Optional[dict] = None,
            mix_overrides: Optional[dict] = None,
            engine_hook: Optional[Callable] = None,
            engine=None, keep_answers: bool = False) -> dict:
    """One run of the cell ``name``; returns the result line as a dict.
    ``engine_overrides`` and ``mix_overrides`` change the configuration's
    engine options and the mix's parameters (the controls and the knee's
    sweep); ``engine_hook`` is applied to the engine once it is set up (a
    planted fault); ``engine`` is one already set up for this cell and
    seed."""
    import torch

    w = workload(bench, name)
    cell = make_cell(bench, name, seed, seconds, trace, device, registry,
                     t_start, engine_overrides, mix_overrides,
                     engine_hook=engine_hook, engine=engine)
    mix = cell.mix
    out = loop(mix).run(cell)
    readings = compare(cell, out["answers"])
    readings["unanswered"] = out["unanswered"]
    checks = judge(readings, cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(cell.device)
                    if cell.device.type == "cuda" else "cpu"),
           "count": w["chips"], "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    ctx = dict(out["ctx"], cfg=cell.cfg, window_s=out["window_s"])
    if trace:
        metrics = {}
        for m in metrics_for(bench["per_layer"], w,
                             reported=_e2e_names(bench, w)):
            value = registry.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx.get("trace") is not None:
            dev["busy_s"] = ctx["trace"]["busy_s"]
            dev["window_s"] = ctx["trace"]["window_s"]
    else:
        values = dict(out["e2e"], setup_s=cell.t_window - cell.t_start)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_for(bench["end_to_end"], w)}
    result["metrics"] = metrics
    result["device"] = dev
    if trace and ctx.get("trace") is not None:
        from .tracing import breakdown
        result["breakdown"] = breakdown(ctx["trace"])
    cell.notes.update(readings)
    result["notes"] = cell.notes
    result["checks"] = checks
    if keep_answers:
        result["answers"] = out["answers"]
    return result


def _e2e_names(bench: dict, w: dict) -> set:
    return {m["name"] for m in metrics_for(bench["end_to_end"], w)}


def forbidden_modules() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser("gpubench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(CHECKOUT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    bench = load_benchmark()
    w = workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("gpubench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < w["chips"]:
        print(f"gpubench: {w['name']} needs {w['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = execute(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", Registry(), t_start)
    result["notes"]["card"] = card_line()
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the process holds {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
