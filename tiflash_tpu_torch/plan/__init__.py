"""Counterpart of ``tiflash_tpu/plan``."""
