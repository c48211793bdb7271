"""The AMG's device refresh against its native refresh on the same float64
values: tests/test_torch_amg.py runs it on the CPU, tests/test_torch_gpu.py
on the card. Imports no JAX."""

import numpy as np
import torch

from ceedpetscsolid_tpu_torch.solve.amg import AMGPreconditioner
from ceedpetscsolid_tpu_torch.utils.timing import request


def _stash(prob, seed):
    """The stash of a seeded small displacement (strains ~1e-2)."""
    n = prob.config.box_faces[0]
    u = np.random.default_rng(seed).standard_normal(
        (3, prob.fine_space.num_nodes)) * 1e-2 / n
    return prob._raw_residual(torch.as_tensor(u, dtype=prob.dtype,
                                              device=prob.device))[1]


def check_device_refresh(prob, seeds, **amg_kw) -> list[str]:
    """Build one hierarchy of prob's p = 1 matrix at seeds[0] twice, one on
    prob's device with the device refresh planned, one native on the host;
    refresh both at each later seed and hold the device's against the
    native's (amg_refresh + _extract_values): every level's matrix values
    to 1e-13 of its max |a|, the diagonals' inverses exactly, lambda_max
    to 1e-12 relative, the coarse inverse to 1e-10 of its max. Returns the
    levels' representations."""
    asm = prob._assembler0
    v = prob.p1_values(_stash(prob, seeds[0]))
    dev = AMGPreconditioner(torch.float64, prob.device, **amg_kw)
    nat = AMGPreconditioner(torch.float64, "cpu", **amg_kw)
    dev.setup(asm.from_values(v.cpu().numpy()), source=asm)
    nat.setup(asm.from_values(v.cpu().numpy()))
    assert dev.refreshes_from(asm) and not nat.refreshes_from(asm)
    for seed in seeds[1:]:
        v = prob.p1_values(_stash(prob, seed))
        with request("amg refresh") as req:
            got = dev.refresh(v)
        assert req.totals.counts == {"amg.device_refreshes": 1}
        nat.setup(asm.from_values(v.cpu().numpy()))
        for l, st in enumerate(nat._struct):
            ref = st["vals"][:st["rowptr"][-1]]
            g = got[l].cpu().numpy()
            assert np.abs(g - ref).max() <= 1e-13 * np.abs(ref).max()
            if st["rep"] == "none":
                continue
            gl, nl = dev.data["levels"][l], nat.data["levels"][l]
            assert torch.equal(gl["dinv"].cpu(), nl["dinv"])
            assert abs(gl["lam"] - nl["lam"]) <= 1e-12 * abs(nl["lam"])
            for k in ("a_val", "a_dense"):
                if k in nl:
                    assert np.abs(gl[k].cpu().numpy() - nl[k].numpy()).max() \
                        <= 1e-13 * np.abs(ref).max()
        ci, cn = dev.data["coarse_inv"].cpu(), nat.data["coarse_inv"]
        assert float((ci - cn).abs().max()) <= 1e-10 * float(cn.abs().max())
    return [rep for _, rep in dev.level_summary()]
