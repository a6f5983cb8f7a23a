"""pyrecode_tpu — the ReCoDe codec on JAX.

A from-scratch reimplementation of the ReCoDe ("Reduced Compressed Description")
codec for high-frame-rate direct electron-detector data (Datta et al., Nat Commun
12, 664 (2021)), built around batched device kernels:

* the reduction stage (dark subtraction, thresholding, connected-component
  labeling, centroiding) and all bit-packing paths run as batched, fused
  JAX programs that XLA compiles for the accelerator (an NVIDIA GPU) —
  frames are processed in batches, data-parallel over a `jax.sharding.Mesh`;
* the container layer (ReCoDe v0.1/v0.2 headers, per-frame metadata, seek
  tables, part-file merge) is byte-compatible with the reference implementation
  (NDLOHGRP/pyReCoDe) so files interoperate in both directions;
* the entropy stage is a pluggable backend registry covering the reference's
  compression scheme codes 0-11 with availability gating.

Public API mirrors the reference package surface (see SURVEY.md §2):

    ReCoDeWriter / ReCoDeReader / merge_parts / ReCoDeServer
    InitParams / InputParams / ReCoDeHeader / ReCoDeStructures
"""

from .constants import rc_cfg, map_dtype, get_dtype_code, get_dtype_string
from .params import InitParams, InputParams
from .header import ReCoDeHeader
from .structures import ReCoDeStructures

__version__ = "0.1.0"

__all__ = [
    "rc_cfg",
    "map_dtype",
    "get_dtype_code",
    "get_dtype_string",
    "InitParams",
    "InputParams",
    "ReCoDeHeader",
    "ReCoDeStructures",
    "ReCoDeWriter",
    "ReCoDeReader",
    "merge_parts",
    "ReCoDeServer",
    "__version__",
]


def __getattr__(name):
    # Lazy imports: keep `import pyrecode_tpu` light (no JAX import) so the
    # container layer is usable on hosts without an accelerator runtime.
    if name == "ReCoDeWriter":
        from .writer import ReCoDeWriter

        return ReCoDeWriter
    if name == "ReCoDeReader":
        from .reader import ReCoDeReader

        return ReCoDeReader
    if name == "merge_parts":
        from .reader import merge_parts

        return merge_parts
    if name == "ReCoDeServer":
        from .server import ReCoDeServer

        return ReCoDeServer
    raise AttributeError(f"module 'pyrecode_tpu' has no attribute {name!r}")
