"""hyperFSIncomp with -qextra 1 and 2 under the default p-MG + AMG (levels
[1, 2]), the port against the JAX package (float64, CPU) on the 2^3 clamp
of test_torch_options.py: SNES and KSP equal, u and strain energy to 1e-10
relative. On CUDA the pressure term then runs the generic tile at
(P, 1 + qextra) on every level, P = 3 and 2; here the plain version, held to
JAX. Two JAX p-MG problems (about a minute and a half each), in a file of
their own so that xdist's loadfile spreads them."""

import pytest

from test_torch_options import INCOMP, check_pair, solve_pair


@pytest.mark.parametrize("qextra", [1, 2])
def test_incomp_qextra_matches_jax(qextra, monkeypatch):
    tp, _ = check_pair(*solve_pair(monkeypatch, dict(INCOMP, qextra=qextra)))
    assert tp.pfactory.Q1d == 1 + qextra
    assert tp.level_degrees == [1, 2]
