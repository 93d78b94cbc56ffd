"""The port's own copy of the JAX package's host stage (numpy and C++).

Parsing, the host entropy engines (the Python oracle and the native C++
library, built with g++ into `build/host/` at first use), the prescan that
stages baseline scans for the device's Huffman decode, the delta-wire
packer, the transcoder for progressive and quirk streams, the prefix and
lossless staging, and the numpy reconstruction that serves as the host
oracle. Each module starts as a copy of its counterpart in
`jpeg_decoder_tpu` at commit 0c2d0ea, with what only JAX uses taken out;
none imports JAX or the JAX package. Comments that cite `src/...` name the
sources of the Rust reference decoder the JAX package was modelled on.
The CPU tests (`tests/test_torch_host_copy.py`) hold this copy bit-equal to
`jpeg_decoder_tpu`.
"""
