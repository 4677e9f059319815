"""Counterpart of ``tiflash_tpu/ops``."""
