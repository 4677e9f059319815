"""Counterpart of ``tiflash_tpu/runtime``."""
