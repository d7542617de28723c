"""Attention kernels (parallel/flash_attention.py)."""
