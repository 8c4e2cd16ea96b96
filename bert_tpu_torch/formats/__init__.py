from .ggml_bin import (  # noqa: F401
    GgmlHParams,
    GgmlModelFile,
    TensorRecord,
    read_ggml,
    write_ggml,
)
