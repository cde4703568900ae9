from africanus_tpu_torch.utils.types import complex_dtype_for, real_dtype_for
from africanus_tpu_torch.utils.docs import DocstringTemplate, doc_tuple_to_str, mod_docs
from africanus_tpu_torch.utils.shapes import aggregate_chunks, corr_shape
from africanus_tpu_torch.utils.cmdline import parse_python_assigns
from africanus_tpu_torch.utils.patterns import (
    freeze, Multiton, LazyProxy, LazyProxyMultiton,
)
from africanus_tpu_torch.utils.requirements import (
    requires_optional, MissingPackageException,
)
from africanus_tpu_torch.utils.code import format_code, memoize_on_key
from africanus_tpu_torch.utils.progress import EstimatingProgressBar, progress
from africanus_tpu_torch.utils.beams import BeamAxes, beam_grids, beam_filenames

__all__ = [
    "complex_dtype_for", "real_dtype_for",
    "DocstringTemplate", "doc_tuple_to_str", "mod_docs",
    "aggregate_chunks", "corr_shape",
    "parse_python_assigns",
    "BeamAxes", "beam_grids", "beam_filenames",
    "freeze", "Multiton", "LazyProxy", "LazyProxyMultiton",
    "requires_optional", "MissingPackageException",
    "format_code", "memoize_on_key",
    "EstimatingProgressBar", "progress",
]
