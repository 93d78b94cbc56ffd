"""Observability utilities of the port: per-stage timing (`timing`) and the
observed host-to-card link state (`link`), copies of the JAX package's
`utils/` with PyTorch in place of JAX."""
