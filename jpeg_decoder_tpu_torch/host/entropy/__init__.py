"""Copy of `jpeg_decoder_tpu/entropy/__init__.py` at commit 0c2d0ea.

Entropy decode layer: JPEG bitstream -> coefficient / difference tensors.

The bit-serial Huffman stage is the one part of JPEG that cannot run on the MXU;
this package keeps it on the host and turns its output into dense tensors that
feed the batched TPU kernels in `..ops`. Two interchangeable engines:

- `scan_python`: pure-Python oracle, exact semantics, used for validation and as
  the portable fallback.
- `native`: C++ host kernel (built on demand with g++, bound via ctypes), the
  production path, including restart-segment parallelism.

Use `decode_scan_dct` / `decode_scan_lossless` from this module; they dispatch
to the native engine when available.
"""

from . import scan_python
from .bitreader import BitReader
from .native import get_native

__all__ = ["BitReader", "decode_scan_dct", "decode_scan_lossless", "scan_python"]


def decode_scan_dct(*args, **kwargs):
    native = get_native()
    if native is not None:
        return native.decode_scan_dct(*args, **kwargs)
    return scan_python.decode_scan_dct(*args, **kwargs)


def decode_scan_lossless(*args, **kwargs):
    native = get_native()
    if native is not None:
        return native.decode_scan_lossless(*args, **kwargs)
    return scan_python.decode_scan_lossless(*args, **kwargs)
