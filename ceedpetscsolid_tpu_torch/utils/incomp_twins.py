"""float32 against float64 twins of the hyperFSIncomp clamp at degree 4 with
-qextra 1 (chip_smoke.py phase 14's problem) along several load paths.

    python -m ceedpetscsolid_tpu_torch.utils.incomp_twins [--box 8]

The clamp of tests/test_incomp.py (nu 0.49, E 1e6, face 6 fixed, face 5
translated along x, smoother physics nu 0.3) at degree 4, -qextra 1,
p-MG + AMG, CG and Newton rtol 1e-6 (the CLI's float32 policy), solved in
float32 and float64 on the card for each load path: the translation and the
number of load increments. It prints, per path and precision, the Newton
(SNES) and CG (KSP) counts, CG's exit reasons, the strain energy and the
solve seconds, and whether float32 took float64's counts (both converged,
the same SNES, KSP within 10%, no more indefinite CG exits). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..problem import Config, ElasticityProblem

CLAMP = dict(problem="hyperFSIncomp", degree=4, qextra=1, nu=0.49, E=1e6,
             forcing="none", bc_clamp=(6, 5), multigrid="logarithmic",
             nu_smoother=0.3)
# (translation of face 5 along x, load increments)
PATHS = ((0.05, 1), (0.05, 10), (0.01, 1), (0.01, 5), (0.005, 1),
         (0.002, 1))


def solve(box: int, shift: float, increments: int, dtype):
    cfg = Config(**CLAMP, bc_clamp_translate={5: (shift, 0.0, 0.0)},
                 num_increments=increments, box_faces=(box,) * 3,
                 device="cuda", dtype=dtype, ksp_rtol=1e-6)
    cfg.newton.rtol = 1e-6
    prob = ElasticityProblem(cfg)
    t = time.perf_counter()
    info = prob.solve()
    return (info, dict(prob.cg_exits), prob.strain_energy(info.u),
            time.perf_counter() - t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("incomp_twins: no CUDA device", file=sys.stderr)
        return 2
    print(f"hyperFSIncomp clamp, degree 4, -qextra 1, {args.box}^3 box "
          f"({torch.cuda.get_device_name(0)})")
    for shift, inc in PATHS:
        (i32, e32, w32, t32), (i64, e64, w64, t64) = (
            solve(args.box, shift, inc, dt)
            for dt in (torch.float32, torch.float64))
        same = (i32.converged and i64.converged
                and i32.snes_iters == i64.snes_iters
                and abs(i32.ksp_iters - i64.ksp_iters) <= 0.1 * i64.ksp_iters
                and e32.get("indefinite", 0) <= e64.get("indefinite", 0))
        print(f"translate {shift} in {inc} increment(s): float32 SNES "
              f"{i32.snes_iters} KSP {i32.ksp_iters} exits {e32} energy "
              f"{w32:.10e} {t32:.1f} s | float64 SNES {i64.snes_iters} KSP "
              f"{i64.ksp_iters} exits {e64} energy {w64:.10e} {t64:.1f} s | "
              f"float32 {'takes' if same else 'does not take'} float64's "
              "counts", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
