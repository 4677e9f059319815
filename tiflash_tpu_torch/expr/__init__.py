"""Counterpart of ``tiflash_tpu/expr``."""
