"""Annotation tooling (counterpart of cartseg_tpu/tools)."""
