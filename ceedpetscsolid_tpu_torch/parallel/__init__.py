"""Distributed execution on torch.distributed (port of
ceedpetscsolid_tpu/parallel/, without its TPU slab layout)."""
