"""Physics models (QFunction analogs) and their registry.

Names match the reference's -problem CLI enum (elasticity.h:49-53):
linElas, hyperSS, hyperFS, hyperFSIncomp.
"""

from . import hyper_fs, hyper_fs_incomp, hyper_ss, lin_elas
from .base import Physics

REGISTRY = {
    "linElas": lin_elas,
    "hyperSS": hyper_ss,
    "hyperFS": hyper_fs,
    "hyperFSIncomp": hyper_fs_incomp,
}


def get_model(name: str):
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown problem {name!r}; choose from {sorted(REGISTRY)}"
        ) from None


__all__ = ["Physics", "REGISTRY", "get_model"]
