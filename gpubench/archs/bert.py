"""BERT as bert.cpp's ggml-bin file holds it: post-LayerNorm blocks,
learned absolute positions, Q4_0 matrices (``gpubench/weights.py``), and
the plain reference of ``gpubench/reference/bert.py``. The architecture of
every configuration that names none."""

import os

from gpubench.reference.bert import Reference  # noqa: F401
from gpubench.weights import draw, write_ggml  # noqa: F401


def write(directory, cfg, vocab, weights):
    """The ggml-bin file under ``directory``; its path and bytes."""
    path = os.path.join(directory, "model.bin")
    return path, write_ggml(path, cfg, vocab, weights)
