"""hyperFSIncomp (the composite mu + reduced-integration pressure operator)
through the port's DistributedProblem on four gloo rank processes
(float64, CPU), with Jacobi and with p-MG + the replicated AMG coarse
solve, against the JAX package's serial solve, as
tests/test_distributed.py:98-129 holds the JAX package's distributed
driver: both operators run on every rank's interior and boundary batches.
Both cases share one JAX serial reference, the Jacobi CG solve: its
solution is the p-MG serial solve's to 1.4e-14 (|u| ~ 5e-7), and it
compiles in ~15 s where the p-MG serial solve takes ~90 s."""

import numpy as np
import pytest

from ceedpetscsolid_tpu.problem import Config as JConfig
from ceedpetscsolid_tpu.problem import ElasticityProblem as JProblem
from ceedpetscsolid_tpu_torch import native
from ceedpetscsolid_tpu_torch.parallel import launch, tasks

INCOMP = dict(problem="hyperFSIncomp", degree=2, nu=0.3, E=1.0,
              test_mode=True, box_faces=(3, 3, 3), num_increments=2)


@pytest.fixture(scope="module")
def incomp_ref():
    native.build()
    return np.asarray(JProblem(JConfig(**INCOMP, multigrid="none")).solve().u)


@pytest.mark.parametrize("multigrid", ["none", "logarithmic"])
def test_incomp_matches_jax_serial(tmp_path, incomp_ref, multigrid):
    cfg = dict(INCOMP, multigrid=multigrid)
    out = launch.run(tasks.problem_task, 4, "gloo", "cpu", tmp_path,
                     args=(cfg, [("solve", {})]))
    info = out["solve"]["info"]
    assert out["use_mg"] == (multigrid != "none")
    assert info["converged"]
    assert info["rnorm"] < 1e-10
    assert np.abs(out["solve"]["u"] - incomp_ref).max() < 1e-10
    # both operators ran on every rank
    for c in out["solve_counts"]:
        names = {key[0] for key in c["by_physics"]}
        assert names == set() or names >= {"hyperFSIncomp",
                                           "hyperFSIncomp-pressure"}
