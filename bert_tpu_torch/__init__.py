"""bert_tpu_torch — the PyTorch/CUDA port of bert_tpu for an NVIDIA H100.

A second package beside the JAX reference (``bert_tpu``), with its
structure and names: ggml-bin, HF-directory and ``.npz`` loading,
WordPiece tokenizing, packed and bucketed batching, streaming, warmup, the
BERT encoder with hand-written CUDA kernels (csrc/) for the Q4
dequant-matmul, the W8A8 int8 matmul and its activation quantization, the
fused QKV attention, the per-(batch, head) attention and the fused
LayerNorm, the reference-wire embedding server (``python -m
bert_tpu_torch.server``) and the conversion entry points (``python -m
bert_tpu_torch.convert``). It imports torch and numpy, never
JAX or ``bert_tpu``.

Entry points run on the card unless the caller asks for the CPU
(``BertTorch.from_file(path, device="cpu")``), where every kernel's plain
PyTorch version runs instead.
"""

import torch as _torch

# f32 means f32: TF32 keeps ~10 mantissa bits, the H100 form of the
# reduced-precision trap recorded at bert_tpu/ops/common.py:14-25. The f32
# instances of the q4_matmul and fused attention kernels do run on the
# bf16 tensor cores, but as bert_tpu's Precision.HIGHEST runs on the TPU:
# each operand split into three bf16 parts and six products summed in f32,
# which is f32-grade (csrc/q4_matmul.cu), not TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .engine import BertTorch  # noqa: E402,F401
from .params import BertConfig  # noqa: E402,F401
from .quant import QuantTensor  # noqa: E402,F401
from .tokenizer import WordPieceTokenizer, load_tokenizer  # noqa: E402,F401
from .vocab import Vocab  # noqa: E402,F401

__version__ = "0.1.0"
