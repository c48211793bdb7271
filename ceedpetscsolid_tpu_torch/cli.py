"""Command-line entry point, flag-compatible with the reference `elasticity`
binary (reference src/cloptions.c:26-285 and the summary output of
elasticity.c:684-765). Port of ceedpetscsolid_tpu/cli.py.

Usage (the reference's smoke test, elasticity.c:36: linElas, p-multigrid
levels [1, 2, 3] with the AMG coarse solve, silent and 0 on success):
    python -m ceedpetscsolid_tpu_torch.cli -test -degree 3 -nu 0.3 -E 1 \
        -dm_plex_box_faces 3,3,3
-problem takes linElas (the default), hyperSS, hyperFS and hyperFSIncomp;
-coarse_pc_type gamg (the default) is the native SA-AMG V-cycle on the
assembled p = 1 CSR, chebyshev a matrix-free p = 1 Chebyshev polynomial; at
-degree 1 under a multigrid schedule the AMG V-cycle is the whole
preconditioner (PCGAMG); -multigrid none is Jacobi CG.

Runs on CUDA (float32) and raises when no CUDA device is present; every
-degree up to 63 runs there through the hand-written fused apply, from
degree 14 on the global-memory body of its generic tile (an element's
buffers exceed a block's shared memory). The CPU
(float64) runs only when asked for, by the environment setting
CEEDPETSCSOLID_TORCH_DEVICE=cpu (the counterpart of the JAX CLI honouring
JAX_PLATFORMS=cpu). -mesh <file> reads an unstructured Exodus-II hex
mesh (HEX8 or HEX27, its side sets the face sets -bc_clamp names) and
reorders it for locality in place of the box. -view_soln writes each
increment's displacement to solution-NNN.vtu in the working directory, and
it or -view_final_soln writes solution-final.vtu with the nodal
diagnostics (post/vtu.py). Unknown options are reported.
"""

from __future__ import annotations

import os
import sys

# names the device for the CLI (cpu, cuda, cuda:1, ...); unset: CUDA
DEVICE_ENV = "CEEDPETSCSOLID_TORCH_DEVICE"


def _parse_args(argv):
    """PETSc-options-style parser: -key [value] pairs; bools may omit value."""
    opts = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("-"):
            raise SystemExit(f"unexpected argument {tok!r}")
        key = tok.lstrip("-")
        if i + 1 < len(argv) and not _is_flag(argv[i + 1]):
            opts[key] = argv[i + 1]
            i += 2
        else:
            opts[key] = "true"
            i += 1
    return opts


def _is_flag(tok: str) -> bool:
    if not tok.startswith("-"):
        return False
    # negative numbers are values, not flags
    try:
        float(tok.split(",")[0])
        return False
    except ValueError:
        return True


def _ints(s):
    return tuple(int(x) for x in s.split(","))


def _floats(s):
    return tuple(float(x) for x in s.split(","))


def _bool(s):
    return s.lower() in ("true", "1", "yes", "on")


def _coarse_solve(pc_type: str) -> str:
    """-coarse_pc_type: gamg is PETSc's name for the AMG coarse PC."""
    return "amg" if pc_type == "gamg" else pc_type


def build_config(opts: dict):
    from .problem import Config

    known = set()

    def get(key, conv=str, default=None):
        known.add(key)
        if key in opts:
            return conv(opts[key])
        return default

    bc_clamp = get("bc_clamp", _ints, ())
    translate, rotate = {}, {}
    for face in bc_clamp:
        known.add(f"bc_clamp_{face}_translate")
        known.add(f"bc_clamp_{face}_rotate")
        if f"bc_clamp_{face}_translate" in opts:
            translate[face] = _floats(opts[f"bc_clamp_{face}_translate"])
        if f"bc_clamp_{face}_rotate" in opts:
            rotate[face] = _floats(opts[f"bc_clamp_{face}_rotate"])

    nu = get("nu", float, None)
    E = get("E", float, None)
    # required flags (cloptions.c:271-276, 181-184)
    if nu is None:
        raise SystemExit("-nu option needed")
    if E is None:
        raise SystemExit("-E option needed")
    cfg = Config(
        problem=get("problem", str, "linElas"),
        degree=get("degree", int, 3),
        qextra=get("qextra", int, 0),
        nu=nu,
        E=E,
        mesh_file=get("mesh", str, None),
        box_faces=get("dm_plex_box_faces", _ints, (3, 3, 3)),
        box_lower=get("dm_plex_box_lower", _floats, (0.0, 0.0, 0.0)),
        box_upper=get("dm_plex_box_upper", _floats, (1.0, 1.0, 1.0)),
        forcing=get("forcing", str, "none"),
        forcing_vec=get("forcing_vec", _floats, (0.0, -1.0, 0.0)),
        bc_clamp=bc_clamp,
        bc_clamp_translate=translate,
        bc_clamp_rotate=rotate,
        num_increments=get("num_steps", int, None),
        multigrid=get("multigrid", str, "logarithmic"),
        nu_smoother=get("nu_smoother", float, 0.0),
        test_mode=get("test", _bool, False),
        units_meter=get("units_meter", float, 1.0),
        units_second=get("units_second", float, 1.0),
        units_kilogram=get("units_kilogram", float, 1.0),
        ksp_rtol=get("outer_ksp_rtol", float, None),
        ksp_max_it=get("outer_ksp_max_it", int, 10_000),
        ksp_monitor=get("ksp_monitor", _bool, False),
        # `outer_mg_*` configures the level smoothers (PCMGSetNumberSmooth(3),
        # elasticity.c:589), `coarse_*` the coarse solve (elasticity.c:577-582)
        smooth_its=get("outer_mg_smooth_its", int, 3),
        coarse_solve=_coarse_solve(get("coarse_pc_type", str, "amg")),
        coarse_cheb_its=get("coarse_ksp_max_it", int, 30),
        device=os.environ.get(DEVICE_ENV) or None,
    )
    # Newton (SNES) overrides
    cfg.newton.rtol = get("snes_rtol", float, cfg.newton.rtol)
    cfg.newton.atol = get("snes_atol", float, cfg.newton.atol)
    cfg.newton.max_it = get("snes_max_it", int, cfg.newton.max_it)
    ls = get("snes_linesearch_type", str, cfg.newton.linesearch)
    if ls not in ("cp", "basic"):
        raise SystemExit(f"unknown -snes_linesearch_type {ls!r}")
    cfg.newton.linesearch = ls
    cfg.newton.ew = get("snes_ksp_ew", _bool, cfg.newton.ew)
    viewopts = dict(view_soln=get("view_soln", _bool, False),
                    view_final_soln=get("view_final_soln", _bool, False),
                    snes_monitor=get("snes_monitor", _bool, False),
                    snes_view=get("snes_view", _bool, False),
                    log_view=get("log_view", _bool, False))
    known.update({"ceed", "ceed_fine", "memtype"})   # libCEED resource strings
    unknown = set(opts) - known
    if unknown:
        print(f"WARNING: ignoring unknown options: {sorted(unknown)}",
              file=sys.stderr)
    if not cfg.test_mode and not bc_clamp and cfg.forcing != "mms":
        raise SystemExit("-boundary options needed")
    return cfg, viewopts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    opts = _parse_args(argv)
    if "help" in opts:
        print(__doc__)
        return 0

    import torch

    cfg, viewopts = build_config(opts)
    if cfg.ksp_rtol is None:
        # f64 matches the reference's 1e-10; f32 cannot reach it
        f64 = cfg.dtype == torch.float64
        cfg.ksp_rtol = 1e-10 if f64 else 1e-6
        if not f64:
            cfg.newton.rtol = 1e-6
    from .post.vtu import write_vtu
    from .problem import ElasticityProblem

    prob = ElasticityProblem(cfg)
    if viewopts["snes_view"]:
        _print_solver_view(cfg, prob)

    def monitor(inc, load, res):
        if viewopts["snes_monitor"]:
            print(f"{inc - 1} Load Increment")  # elasticity.c:639-642
            u_bc = prob.insert_bc(res.u, prob.bc_values(load))
            energy = prob.strain_energy(u_bc)
            print(f"  SNES iters {res.iters} rnorm {res.rnorm:.6e} "
                  f"energy {energy:.9e}")
        if viewopts["view_soln"]:
            # per-increment solution output (misc.c:188-212); a retried
            # sub-step overwrites its increment's file
            u_out = prob.insert_bc(res.u, prob.bc_values(load))
            write_vtu(f"solution-{inc:03d}.vtu", prob.fine_space,
                      u_out.detach().cpu().numpy())

    info = prob.solve(monitor=monitor)

    if viewopts["view_soln"] or viewopts["view_final_soln"]:
        diag = prob.diagnostics(info.u)
        write_vtu("solution-final.vtu", prob.fine_space,
                  info.u.detach().cpu().numpy(), diag.cpu().numpy())

    test_mode = cfg.test_mode
    if not test_mode:
        _print_summary(cfg, prob, info)
    if viewopts["log_view"]:
        print(prob.log.report())

    if cfg.forcing == "mms":
        err = prob.mms_error(info.u)
        # elasticity.c:806-811: silent in test mode unless error > 0.05
        if not test_mode or err > 0.05:
            print(f"  L2 Error: {err:.5e}")
            if test_mode:
                return 1
    return 0


def _print_solver_view(cfg, prob):
    """-snes_view analog: echo the solver tree (the PC/PCMG configuration
    echo of elasticity.c:716-748)."""
    print("SNES Object: newton")
    print(f"  line search: {cfg.newton.linesearch} "
          f"(max {cfg.newton.ls_max_it} secant steps)")
    print(f"  rtol {cfg.newton.rtol:g} atol {cfg.newton.atol:g} "
          f"max_it {cfg.newton.max_it}")
    print("  KSP Object: (outer_) cg, natural norm")
    print(f"    rtol {cfg.ksp_rtol:g} max_it {cfg.ksp_max_it}")
    if cfg.multigrid == "none" or len(prob.level_degrees) == 1:
        pc = "gamg(native SA-AMG)" if prob._use_amg else "jacobi"
        print(f"  PC Object: {pc}")
        return
    print(f"  PC Object: mg (p-multigrid, {cfg.multigrid} schedule, "
          f"levels p = {prob.level_degrees})")
    print(f"    smoother: chebyshev({cfg.smooth_its}) + jacobi, "
          "eig bounds 0.1/1.1 * lambda_max (est per Jacobian)")
    if cfg.nu_smoother:
        print(f"    smoother physics: nu = {cfg.nu_smoother}")
    if cfg.coarse_solve == "amg":
        print("    coarse: (coarse_) native SA-AMG V-cycle on assembled "
              "p=1 CSR")
    else:
        print(f"    coarse: (coarse_) chebyshev({cfg.coarse_cheb_its}), "
              "matrix-free p=1")


def _print_summary(cfg, prob, info):
    """Structured run summary (elasticity.c:306-375, 684-765)."""
    fes = prob.fine_space
    print("-- Elasticity / Hyperelasticity -- PyTorch/CUDA --")
    print(f"  Problem: {cfg.problem}")
    print(f"  Device:  {prob.device} ({str(prob.dtype).replace('torch.', '')})")
    print(f"  Mesh:    {fes.num_elements} elements, degree {cfg.degree}, "
          f"{fes.num_nodes} nodes, {3 * fes.num_nodes} DoFs")
    print(f"  Physics: nu = {cfg.nu}, E = {cfg.E}")
    print(f"  Multigrid levels: {prob.level_degrees}")
    print(f"  SNES iterations: {info.snes_iters}  (reason: {info.reason})")
    print(f"  KSP iterations:  {info.ksp_iters}")
    print(f"  Final rnorm:     {info.rnorm:.6e}")
    print(f"  Solve time:      {info.solve_time:.3f} s "
          f"(preconditioner setup {info.pc_time:.3f} s)")
    print(f"  DoFs/sec in SNES: {info.mdofs_per_sec:.3f} M")
    energy = prob.strain_energy(info.u)
    print(f"  Strain energy:    {energy:.10e}")


if __name__ == "__main__":
    raise SystemExit(main())
