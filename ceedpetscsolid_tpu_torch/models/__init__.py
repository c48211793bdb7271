"""Physics models (QFunction analogs) and their registry.

Names match the reference's -problem CLI enum (elasticity.h:49-53). The port
has hyperFS so far; linElas, hyperSS and hyperFSIncomp exist only in the
JAX package and are refused by name.
"""

from . import hyper_fs
from .base import Physics

REGISTRY = {"hyperFS": hyper_fs}
NOT_PORTED = ("linElas", "hyperSS", "hyperFSIncomp")


def get_model(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"-problem {name} is not ported to ceedpetscsolid_tpu_torch yet "
            f"(ported: {sorted(REGISTRY)})")
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown problem {name!r}; choose from "
            f"{sorted(REGISTRY) + list(NOT_PORTED)}"
        ) from None


__all__ = ["Physics", "REGISTRY", "get_model"]
