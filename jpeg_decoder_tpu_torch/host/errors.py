"""Copy of `jpeg_decoder_tpu/errors.py` at commit 0c2d0ea.

Typed error model for the TPU-native JPEG decode engine.

Capability parity with the reference error model (`src/error.rs:16-75`):
a format error carrying a detail string, a typed "unsupported feature" error, and an
I/O error. Errors are exceptions here (idiomatic Python) rather than a Result enum.
"""

from __future__ import annotations

import enum


class UnsupportedFeature(enum.Enum):
    """JPEG features the engine intentionally rejects with a typed error.

    Mirrors `src/error.rs:16-34`.
    """

    HIERARCHICAL = "hierarchical"
    ARITHMETIC_ENTROPY_CODING = "arithmetic entropy coding"
    SAMPLE_PRECISION = "sample precision"
    COMPONENT_COUNT = "component count"
    DNL = "DNL"
    SUBSAMPLING_RATIO = "subsampling ratio"
    NON_INTEGER_SUBSAMPLING_RATIO = "non-integer subsampling ratio"
    COLOR_TRANSFORM = "color transform"


class JpegError(Exception):
    """Base class for all decode errors raised by this package."""


class FormatError(JpegError):
    """The image is not formatted properly (`Error::Format`).

    Carries a human-readable description, like the reference's detail string
    (`src/error.rs:38-41`).
    """

    def __init__(self, message: str):
        super().__init__(f"invalid JPEG format: {message}")
        self.detail = message


class UnsupportedError(JpegError):
    """The image uses a feature this engine does not support (`Error::Unsupported`)."""

    def __init__(self, feature: UnsupportedFeature, detail: object = None):
        self.feature = feature
        self.feature_detail = detail
        msg = f"unsupported JPEG feature: {feature.value}"
        if detail is not None:
            msg += f" ({detail})"
        super().__init__(msg)


class IoError(JpegError):
    """An I/O error occurred while decoding (`Error::Io`).

    In this engine the only I/O failure mode for in-memory buffers is running off
    the end of the data (unexpected EOF).
    """

    def __init__(self, message: str = "unexpected end of data"):
        super().__init__(message)


class InternalError(JpegError):
    """An internal invariant was violated (`Error::Internal`). Indicates a bug."""
