#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ceedpetscsolid_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase4b       # phase 4b, then 6-7's counters
    python3 chip_smoke.py --phase18 d     # phase 18's parts alone
    python3 chip_smoke.py --phase20       # the whole rank-count sweep

Phases, each of which raises on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the CUDA kernels from the checkout's sources (one nvcc per
     compile unit, all started together);
  3. kernel vs its plain torch version on the same inputs: hyperFS degree 4
     on a 24^3 box (13,824 elements, 2,738,019 DoF), degrees 2 and 3 on a
     4^3 box and on the scrambled (unstructured-numbering) 4^3 box, and
     degrees 1 and 2 on the 16^3 box (phase 7's (2,2) and (3,3) levels).
     float64 kernel vs float64 plain: max|diff| <= 1e-12 max|ref|;
     float32 kernel vs float64 plain: |diff| <= 2e-5 |ref| + 1e-6 max|ref|
     (float32 rounding alone reaches ~6e-7 max|ref| in the plain version);
     then the tiles' edges (EDGE_CASES): one element (a tile larger than
     the mesh), element counts that leave the last warp tile ragged
     ((2,2), (3,3), (4,4) with 8, 3 and 2 elements a tile), float64 at
     P = Q = 6, and both copy paths: TMA bulk copies where every staged
     plane is a multiple of 16 bytes, cp.async where it is not or where
     the streams start one word off 16 bytes (hyperFS, and hyperSS, whose
     J.v reads its stash unstaged); the launches are counted per copy path
     and each path must have run in both modes;
  3b. the fused apply's P < Q instances (2, 5), (3, 5), (5, 6) (a coarse
     p-multigrid level at the fine level's Gauss rule, or -qextra 1) against
     the plain version on the 4^3 box and the scrambled 4^3 box, (2, 5) and
     (3, 5) also on the 8^3 box (phase 8's levels), at the tolerances of
     phase 3, and their CUDA-event times on the 16^3 box;
  3c. the other physics' instances against their plain versions at phase
     3's tolerances, residual (with stash) and J.v: linElas (no stash),
     hyperSS and hyperFSIncomp's mu part at 24^3 degree 4, 4^3 degrees 2
     and 3 and the scrambled 4^3 box; hyperFSIncomp's pressure part at
     (P, 1), P = 2..5, on the 4^3 box and the scrambled 4^3 box; call and
     device times of each at 24^3 degree 4 in float32, kernel and plain,
     beside the bound from shapes (fused_apply.bound_ms: each input byte
     read once, each output byte written once, at 3.35 TB/s, or the flops
     at 67 TFLOP/s if more) and the device time's share of it;
  3d. the generic tile (every (physics, P, Q) without a template instance,
     P and Q at run time) against the plain version at phase 3's
     tolerances: the pressure term at (P, Q), P = 2..5, Q = 2, 3, on the
     4^3 box and the scrambled 4^3 box; hyperFS and linElas at (7, 7),
     (8, 8), (6, 7), (2, 7) on the 3^3 box; hyperFS at (10, 10) on one
     element (float64 and float32: the cluster body); the tile's
     edges (GENERIC_EDGES: one element, misaligned streams, tiles of two
     elements with a ragged last one); every body of the plan
     (fused_apply.GENERIC_BODIES) must run, each register body by both
     copy paths, with tiles of one element on fewer tiles than SMs and of
     more than one; then, where the solves launch the generic tile
     (GENERIC_TIMED: the pressure term at (5, 2), (3, 2), (2, 2) on 8^3,
     phase 14; hyperFS (7, 7) on 6^3, phase 15) and at (5, 2) on 24^3 and
     (7, 7) on 12^3, each shape held against the plain version as above
     and then timed, float32, call and device, beside the bound and the
     launch plan; then the cluster body ("cluster": one element a
     thread-block cluster of k CTAs, above P, Q = 8) where one element
     exceeds a block's shared memory, at (12, 12) f64 (every physics with
     a stash, linElas), (15, 15) f32 and the pressure term's (21, 2) f64
     on one element, streams one word off 16 bytes at (12, 12) and 343
     elements (more clusters than the card runs at once), and at (9, 9),
     (11, 11) and (14, 14); the global-memory body ("gmem": where no
     cluster of 8 CTAs holds an element) at (23, 23) f64 on one element
     and on a persistent grid with a ragged last round (7^3: 343 elements
     on 264 blocks); each against the plain version (the input's amplitude
     divided by (P / 5)^2, so that gradu stays ~1e-2: a random nodal
     field's gradient grows with P^2, and at O(1) strain float32 rounding
     is amplified in the plain version too); and timed where phase 19
     launches it, (15, 15) f32 on 5^3 and (12, 12) f64 on 6^3, with the
     (9, 9) level on each, at the plan's cluster size and at the fewest
     CTAs that fit, twice and four times as many (within 8), each size
     held against the plain version first; the rows print the cluster
     size, each CTA's shared memory and the cluster count;
  4. CUDA-event times (median of 20 calls after warm-up) of kernel and plain
     version, residual and J.v, at the 24^3 degree-4 shapes, in float32: of
     one call, the host's enqueue included, and of the device's work alone
     (utils.timing.cuda_device_ms), with the bound and share as in 3c;
  4b. the owner-sum kernel (csrc/owner_sum.cu, Restriction.scatter_add on
     the card) on the restrictions the main paths build (owner_sum_cases:
     24^3 and 28^3 p4, phase 7's p = 1, 2 levels on 16^3, the scrambled
     4^3 box at p2, one rank's restr_int and restr_bnd of phase 18's
     partition) for 1, 3 and 8 components in float32 and float64: bit for
     bit the sum in the kernel's order (csr_sum: plain torch on the card),
     and
     within 8 eps of each node's sum of magnitudes of the padded plain sum
     that ran before it; then at 28^3 p4 (3 and 1 components float32, 3
     and 8 float64) call and device times of the kernel, the padded plain
     sum and one index_add_ into zeros (atomics: not in a fixed order),
     beside the bound from the bytes (E-vector and positions read once,
     offsets once, L-vector written once, at 3.35 TB/s);
  5. the reference smoke flags in hyperFS form through cli.main, checked
     against the JAX package's result on the same flags;
  6. slice 1's main path: hyperFS degree 4 on a 16^3 box (823,875 DoF),
     -test, -multigrid none (Jacobi CG), one increment, float32, through
     ElasticityProblem; a float64 twin of the same solve checks the answer;
  7. slice 2's main path: the same problem with the p-multigrid
     preconditioner (logarithmic levels [1, 2, 4], native level quadrature,
     Chebyshev(3) smoothers, Chebyshev(30) coarse solve), float32, with its
     float64 twin, held against phase 6's answer and its CG count;
  8. the p-MG solve at 8^3 with fine level quadrature, so that the (2, 5)
     and (3, 5) instances run inside a solve;
  9. the row-gather probes (K3-K6): the entry point
     `python -m ceedpetscsolid_tpu_torch.ops.gather_probe` as a user runs it
     (K3/K4 must launch as thread-block clusters of more than one block),
     then each kernel against its plain version on
     gather_probe.probe_cases: the script's shape, a ragged one, a narrow
     table, one that spans a cluster, one cut into column slabs,
     out-of-range indices (the JAX ops' wrap, NaN-fill, clamp and one-hot
     semantics) and a table with non-finite values and signed zeros;
     K3-K5 bitwise, K6 with NaN positions equal and every other value
     bitwise (gather_probe.probe_equal); call and device times of each
     kernel and plain version at the probe's shape beside bare tab[idx] and
     the one-hot matrix product (cuBLAS), and gather_loop's call and device
     ms, bound and share vs index_select at the production shape;
 10. the reference's own smoke test, its flags exactly (linElas, p-MG
     [1, 2, 3], AMG coarse solve), through cli.main: rc 0, silent, MMS
     rel-L2 within 1% of the JAX package's f64 value (float32 CG stops at
     the CLI's rtol 1e-6: ~1e-6 of |u| through a 2.85e-4 error moves it by
     up to ~0.4%), and its KSP count beside the JAX package's 8;
 11. slice 4's main path: phase 7's problem with the default AMG coarse
     solve, float32, with its float64 twin (same tolerances), held against
     phase 7's answer: AMG levels, J.v launches per CG iteration, the AMG
     refresh split (element matrices, d2h, native setup, upload);
 12. linElas degree 4 on the 16^3 box (-test, p-MG + AMG) with its float64
     twin; the hyperSS and hyperFSIncomp clamp solves of tests/test_amg.py
     and tests/test_incomp.py at 8^3 degree 2, float32 against a float64
     twin at the same tolerances: the same SNES count, KSP within 10%,
     energy to 1e-5;
 13. PCGAMG: linElas -test degree 1 on a 32^3 box (107,811 DoF), CG
     preconditioned by the AMG V-cycle alone, with its float64 twin;
 14. hyperFSIncomp with -qextra 1: phase 12's clamp solve at degree 4 on
     the 8^3 box (p-MG [1, 2, 4] + AMG), float32 against its float64 twin:
     converged, energy to 1e-5, u to 1e-3, no more indefinite CG exits;
     the SNES and KSP counts printed beside the twin's (see INCOMP_QEXTRA);
     the pressure term runs the generic tile at (5, 2), (3, 2) and (2, 2);
 15. hyperFS -test at degree 6 on a 6^3 box (151,959 DoF), p-MG [1, 2, 4,
     6] + AMG, float32, with its float64 twin: the fine level runs the
     generic tile at (7, 7);
 16. the Exodus-II path at the size of phase 11: the scrambled 16^3 box
     written as a HEX27 file (side set 998 on x = 0, 999 on x = 1, found
     by coordinates), solved through cli.main -mesh (hyperFS degree 4,
     clamped on 998, 999 translated, one increment, p-MG + AMG, float32),
     against the lattice 16^3 box through the same CLI with its own face
     ids: the same SNES count, energy and u at nodes matched by
     coordinates to 1e-3; both KSP counts printed (the AMG aggregates by
     ordering);
 17. slice 9's post-processing and continuation control: (a) the nodal
     diagnostics of phase 11's solution (ElasticityProblem.diagnostics,
     float64 on the card), every column to 1e-12 of the float64
     multigrid=none problem's on the same u and columns 0-2 equal to u,
     their device and call ms beside phase 11's solve seconds, then
     solution-final.vtu of them in build/chip_smoke/ (write seconds, MB),
     parsed back with xml.etree: (4 n + 1)^3 points, (4 n)^3 cells and the
     displacement to the 9 digits written; (b) RESUME, a hyperFS degree-4
     clamp in four increments on the 8^3 box (p-MG + AMG, float32, Newton
     rtol 1e-5), unbroken, then cut at load 0.5 (Config.stop_at_load) and
     resumed in a fresh problem from its monitor's checkpoint: the same
     SNES count, KSP
     within 10%, u to 1e-4, energy to 1e-5, no indefinite CG exit; (c) the
     same clamp with NewtonOptions.ls_max_it 2 (the step-by-step secant
     line search), float32 against its float64 twin at phase 12's
     tolerances; (d) the reference smoke flags with -view_soln
     -view_final_soln through cli.main in build/chip_smoke/cli/: every
     increment's file and the final one, parsed back;
 18. the distributed driver (parallel/: DistributedProblem on
     torch.distributed, the fused kernel on every rank's interior and
     boundary batches): phase 11's problem at the fine level quadrature
     (the JAX package's distributed p-MG integrates every level there),
     float32, Newton rtol 1e-5 (DIST_RTOL), against the serial solve of the
     same configuration: (a) one NCCL rank in this process, (b) four gloo
     ranks on this card (parallel/launch.py): |G| at u = 0 to 1e-5, SNES
     equal, KSP at most the serial's + 2, u to 1e-5; halo statistics,
     partition_space's seconds, wall per Newton step and the share of it
     in the exchanges (Comm.seconds: the host's clock under gloo, the
     device's under NCCL), every rank's launches by path (each rank's launches
     equal to its batch applies: none ran the plain version); (c) one
     Newton step, float64, of hyperFSIncomp degree 2 on 3^3 and of hyperFS
     degree 2 on phase 16's HEX27 file (Config.mesh_file), both p-MG +
     AMG, on four gloo ranks: entry |G| to 1e-5 of the serial operator's,
     |G| decreasing; (d) four NCCL ranks, one a card, only where the
     machine has four cards (otherwise one line says so);
 19. the high degrees, phase 15's -test setup, p-MG + AMG: hyperFS degree
     14, float32, on the 5^3 box (1,073,733 DoF, levels [1, 2, 4, 8, 14])
     through cli.main (with -num_steps 1, as phase 15's one increment),
     held to its float64 twin at phase 15's tolerances (SNES and KSP
     printed beside the twin's); hyperFS degree 11, float64, on the 6^3
     box (902,289 DoF, levels [1, 2, 4, 8, 11]) through
     ElasticityProblem. Their fine levels, (15, 15) and (12, 12), and the
     (9, 9) level run the generic tile's cluster body: the fine residual
     and J.v and the (9, 9) J.v must each launch the body its plan names;
     the launches are printed per path (template instances: bulk, async;
     generic: the register bodies, cluster, gmem). Then the degree-14
     float32 solve with Jacobi CG (-multigrid none), held to the p-MG
     answer as phase 7 holds p-MG to phase 6's Jacobi solve: its solve
     wall and, from a second solve under torch.profiler, its fused J.v
     device ms.
 20. the rank-count sweeps (utils/weak_scaling.py, the counterpart of the
     JAX package's scripts/weak_scaling.py): the jax series' fixed-work
     Newton step (hyperFS p3, faces (24, 24, 4n), p-MG + AMG, ksp_rtol 0,
     10 CG iterations, float32, SWEEP_REPS timed reps) at n = 1 (one NCCL
     rank in this process) and n = 2 (two gloo ranks on this card: host
     staging, not a scaling point), and the invariance series (a
     scrambled HEX27 file at degree 2, two increments, solved to Newton
     rtol 1e-5) on one NCCL rank and two gloo ranks against the serial
     solve; each point's numbers with the card line. Checks: every point
     ran 10 CG iterations, every rank's batches the fused kernel, the
     invariance points the serial SNES, KSP within +2 and u within
     DIST_TOL. `python3 chip_smoke.py --phase20` runs, after the build
     alone, the whole sweep instead: the jax, card and unstructured
     series and the invariance series on 1, 2 and 4 NCCL cards where the
     machine has them (it says which n it skipped), SWEEP_FULL_REPS reps
     and rank 0's profile of one step a point, and also checks that the
     box series' halo a rank is constant for n > 1; its records go to
     build/chip_smoke/weak/.
In phases 10-13 CG may exit on p.Ap <= 0 (the sign of an AMG cycle that
stopped being SPD in float32) no more often than in the float64 twin
(phase 12's clamp solves, whose tangents are themselves indefinite at the
first Newton steps), and not at all elsewhere. Kernel launch counters are
set to 0 just before each main path (phases 6-17, 19) and read just after,
the fused apply's also per copy path (phase 18: per job on every rank);
every solve through ElasticityProblem's request must launch the owner-sum
kernel once an owner-sum (restr.owner_sum_kernel = restr.owner_sum_calls).
Then one JSON line of per-kernel
results (each with its bound from this run's shapes, `bound_by`, and
`library_ms`: bare `tab[idx]` for the probes, none for the fused apply,
which no one PyTorch call computes, index_add_ for the owner-sum, whose
rows count the kernel's launches in phases 6 and 7; K6 also carries
`matmul_ms`, the one-hot product through cuBLAS, and K5 its
production-shape numbers),
the card line, and as the last line
{"ok": true, "device": {...}}. The generic tile's rows name the body
(generic_plan) and the dtype of the shape they time. Without a CUDA
device it exits 2, without the package beside this script 3, and it
prints no result; any other error propagates with its traceback.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# JAX package, f64 on the CPU, for the phase-5 flags (rc, MMS rel-L2);
# tests/test_torch_problem.py re-checks the port against it on every run.
SMOKE_FLAGS = ["-problem", "hyperFS", "-test", "-degree", "3", "-nu", "0.3",
               "-E", "1", "-dm_plex_box_faces", "3,3,3", "-multigrid", "none",
               "-num_steps", "1"]
SMOKE_REF_RC, SMOKE_REF_L2 = 1, 6.21859e-02
TPU_KERNEL = "ceedpetscsolid_tpu/ops/pallas_apply.py:172"
KERNEL_BOX, SOLVE_BOX = 24, 16       # elements per side: phases 3-4, 6-7
FINE_LEVEL_BOX = 8                   # phase 8
PQ_LESS = ((2, 5), (3, 5), (5, 6))   # phase 3b
NEW_PHYSICS = ("linElas", "hyperSS", "hyperFSIncomp")     # phase 3c
PRESSURE = "hyperFSIncomp-pressure"
# elasticity.c:36 with every default; the JAX package's result on it (f64,
# CPU; tests/test_torch_amg_solve.py re-checks the port on every run)
REFERENCE_SMOKE = ["-test", "-degree", "3", "-nu", "0.3", "-E", "1",
                   "-dm_plex_box_faces", "3,3,3"]
REFERENCE_L2, REFERENCE_KSP, REFERENCE_L2_RTOL = 2.85047e-04, 8, 1e-2
PCGAMG_BOX = 32                      # phase 13
CLAMP_BOX = 8                        # phase 12
CLAMP = {                            # tests/test_amg.py, tests/test_incomp.py
    "hyperSS": dict(problem="hyperSS", degree=2, nu=0.3, E=1e6,
                    forcing="none", bc_clamp=(6, 5),
                    bc_clamp_translate={5: (0.0, 0.0, 0.05)},
                    num_increments=1, multigrid="logarithmic"),
    "hyperFSIncomp": dict(problem="hyperFSIncomp", degree=2, nu=0.49, E=1e6,
                          forcing="none", bc_clamp=(6, 5),
                          bc_clamp_translate={5: (0.05, 0.0, 0.0)},
                          num_increments=1, multigrid="logarithmic",
                          nu_smoother=0.3),
}
GENERIC_PQ = ((7, 7), (8, 8), (6, 7), (2, 7))     # phase 3d, Q > 6
# phase 3d's tile edges: (label, box faces, P, Q, physics, misaligned
# streams). One element (at Q = 3 a 108-byte plane: cp.async); streams one
# word off 16 bytes (cp.async: a Q = 2 plane is always a multiple of 16
# bytes); warp tiles of 2 elements (1,331 // (4 x 132)) and a block tile
# of 2 (343 // 132), each with a ragged last tile
GENERIC_EDGES = (("1^3", (1, 1, 1), 5, 2, PRESSURE, False),
                 ("1^3", (1, 1, 1), 3, 3, PRESSURE, False),
                 ("1^3", (1, 1, 1), 7, 7, "hyperFS", False),
                 ("4^3 misaligned", (4, 4, 4), 3, 2, PRESSURE, True),
                 ("4^3 misaligned", (4, 4, 4), 5, 2, PRESSURE, True),
                 ("11^3", (11, 11, 11), 5, 2, PRESSURE, False),
                 ("11^3", (11, 11, 11), 3, 2, PRESSURE, False),
                 ("11^3", (11, 11, 11), 7, 1, PRESSURE, False),
                 ("7^3", (7, 7, 7), 3, 4, PRESSURE, False))
# phase 3d's cluster shapes: (label, box faces, P, Q, physics, misaligned
# streams). Where one element exceeds a block's shared memory (the gmem
# body's shapes before the cluster body: two CTAs or more an element), one
# element each, streams one word off 16 bytes, and 343 elements (more
# clusters than the card runs at once); one CTA an element's largest
# shapes, (11, 11) f64 and (14, 14) f32, and phase 19's (9, 9) level
CLUSTER_EDGES = (("1^3", (1, 1, 1), 12, 12, "hyperFS", False),
                 ("1^3", (1, 1, 1), 12, 12, "linElas", False),
                 ("1^3", (1, 1, 1), 12, 12, "hyperSS", False),
                 ("1^3", (1, 1, 1), 12, 12, "hyperFSIncomp", False),
                 ("1^3", (1, 1, 1), 15, 15, "hyperFS", False),
                 ("1^3", (1, 1, 1), 21, 2, PRESSURE, False),
                 ("1^3 misaligned", (1, 1, 1), 12, 12, "hyperFS", True),
                 ("7^3", (7, 7, 7), 12, 12, "hyperFS", False),
                 ("1^3", (1, 1, 1), 9, 9, "hyperFS", False),
                 ("1^3", (1, 1, 1), 11, 11, "hyperFS", False),
                 ("1^3", (1, 1, 1), 14, 14, "hyperFS", False))
# phase 3d's gmem shapes, where no cluster of 8 CTAs holds an element
# ((23, 23) f64; its f32 runs the cluster body): one element, and 343 on a
# persistent grid of 264 blocks (two an SM), whose first 79 take a second
GMEM_EDGES = (("1^3", (1, 1, 1), 23, 23, "hyperFS", False),
              ("7^3", (7, 7, 7), 23, 23, "hyperFS", False))
# phase 3d's times: (physics, box, P, Q, modes, dtype): where phase 14's,
# 15's and 19's solves launch the generic tile (8^3, 6^3; 5^3 and 6^3),
# then 24^3 and 12^3
F32, F64 = "float32", "float64"
GENERIC_TIMED = ((PRESSURE, 8, 5, 2, ("residual", "jacobian"), F32),
                 (PRESSURE, 8, 3, 2, ("jacobian",), F32),
                 (PRESSURE, 8, 2, 2, ("jacobian",), F32),
                 ("hyperFS", 6, 7, 7, ("residual", "jacobian"), F32),
                 ("hyperFS", 5, 15, 15, ("residual", "jacobian"), F32),
                 ("hyperFS", 5, 9, 9, ("jacobian",), F32),
                 ("hyperFS", 6, 12, 12, ("residual", "jacobian"), F64),
                 ("hyperFS", 6, 9, 9, ("jacobian",), F64),
                 (PRESSURE, 24, 5, 2, ("residual", "jacobian"), F32),
                 ("hyperFS", 12, 7, 7, ("residual", "jacobian"), F32))
# phase 14: phase 12's hyperFSIncomp clamp at degree 4 with -qextra 1. Its
# float32 solve reaches its float64 twin's answer by another Newton path
# (more steps: float64's are indefinite at first, float32's sit near their
# noise floor at rtol 1e-6; the plain float32 version on the CPU too), so
# the counts are printed beside the twin's, not held to them (PERF.md §6,
# runs G1-G3; ROADMAP Queue 3)
INCOMP_QEXTRA = dict(CLAMP["hyperFSIncomp"], degree=4, qextra=1)
DEGREE6_BOX = 6                      # phase 15
# phase 19: (degree, box, dtype) of the two high-degree solves; the first
# through cli.main with HIGH_DEGREE_FLAGS
HIGH_DEGREE = ((14, 5, F32), (11, 6, F64))
HIGH_DEGREE_FLAGS = ["-problem", "hyperFS", "-test", "-degree", "14", "-nu",
                     "0.3", "-E", "1", "-dm_plex_box_faces", "5,5,5",
                     "-num_steps", "1"]
EXODUS_BOX = 16                      # phase 16
# phase 16: hyperFS degree 4, one increment, the clamped face fixed and the
# other translated by 1% of the box (no sub-steps)
EXODUS_FLAGS = ["-problem", "hyperFS", "-degree", "4", "-nu", "0.3", "-E",
                "1", "-num_steps", "1"]
EXODUS_SHIFT = "0.01,0,0"
# phase 17(b, c): a hyperFS degree-4 clamp on the CLAMP_BOX^3 box in four
# increments, face 5 translated by 10% of the box along x and 5% along z,
# at Newton rtol 1e-5: on the CPU every increment then takes four Newton
# steps in float32 and float64 alike, each precision's last residual 10x
# below the threshold. At the CLI's 1e-6 the float32 increments end at
# their noise floor (~2e-6 of the entry residual) by stagnation, in more
# steps than float64's, which the resume's and the twins' counts would
# then measure instead of what they check.
RESUME = dict(problem="hyperFS", degree=4, nu=0.3, E=1.0, forcing="none",
              bc_clamp=(6, 5), bc_clamp_translate={5: (0.1, 0.0, 0.05)},
              num_increments=4, multigrid="logarithmic")
RESUME_RTOL = 1e-5
# phase 18: phase 11's problem at the fine level quadrature, float32 (the
# CLI's float32 KSP rtol), solved to Newton rtol 1e-5 (DistributedProblem's
# default 1e-8 is set for float64), serial and distributed alike
DIST_CONFIG = dict(problem="hyperFS", degree=4, nu=0.3, E=1.0,
                   test_mode=True, box_faces=(SOLVE_BOX,) * 3,
                   multigrid="logarithmic", coarse_solve="amg",
                   level_quadrature="fine", num_increments=1, ksp_rtol=1e-6)
DIST_RTOL = 1e-5
DIST_WORLD = 4
DIST_TOL = 1e-5                     # |G| parity and u (float32)
KERNEL_PATHS = {"bulk", "async", "generic", "generic_gmem", "generic_cluster"}
SWEEP_REPS = 3                      # phase 20's timed steps a point
SWEEP_FULL_REPS = 5                 # --phase20's
CU_SOURCE = "ceedpetscsolid_tpu_torch/csrc/fused_apply.cu"
PROBE_SOURCE = "ceedpetscsolid_tpu_torch/csrc/gather_probe.cu"
PROBE_TPU = {"take": "scripts/try_pallas_gather.py:44",
             "take_along_axis": "scripts/try_pallas_gather.py:56",
             "loop": "scripts/try_pallas_gather.py:70",
             "onehot": "scripts/try_pallas_gather.py:85"}
OWNER_SUM_SOURCE = "ceedpetscsolid_tpu_torch/csrc/owner_sum.cu"
OWNER_SUM_BOX = 28                   # phase 4b: the benchmark's 28^3 box
OWNER_SUM_NCOMP = (1, 3, 8)          # multiplicity, fields, diagnostics
# phase 4b's times at OWNER_SUM_BOX p4: (components, dtype)
OWNER_SUM_TIMED = ((3, "float32"), (1, "float32"), (3, "float64"),
                   (8, "float64"))
FAILED = []                          # phase-3 comparisons that failed
# phase 3's tile edges: (label, box faces, degree, misaligned streams)
EDGE_CASES = (("1^3 p4 (one element)", (1, 1, 1), 4, False),
              ("3^3 p4 (27 x 125 words: cp.async)", (3, 3, 3), 4, False),
              ("4x3x2 p4 (bulk)", (4, 3, 2), 4, False),
              ("4x3x2 p4 misaligned (cp.async)", (4, 3, 2), 4, True),
              ("3^3 p1 (ragged tile of 8)", (3, 3, 3), 1, False),
              ("2x2x1 p2 (ragged tile of 3)", (2, 2, 1), 2, False),
              ("3^3 p3 (ragged tile of 2)", (3, 3, 3), 3, False),
              ("1^3 p1 (one element, tile of 8)", (1, 1, 1), 1, False),
              ("2^3 p5 (P = Q = 6)", (2, 2, 2), 5, False))


def log(msg=""):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def make_case(mesh, degree, dtype, device, seed, qextra=0, q1d=None,
              scale=1.0):
    """Factory, qdata and seeded inputs u, v on `device`. The amplitude
    shrinks with the element size so gradu stays ~1e-2 on every mesh, as
    with the 1e-3 inputs on the 3^3 boxes of tests/test_pallas_apply.py
    (rough inputs at O(1) strain make C nearly singular, where any change
    of rounding order is amplified); `scale` multiplies it (the gmem
    shapes: (5 / P)^2, as the gradient of a random nodal field grows with
    P^2)."""
    import torch

    from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
    from ceedpetscsolid_tpu_torch.ops.operator import OperatorFactory

    f = OperatorFactory(build_fespace(mesh, degree), qextra=qextra,
                        dtype=dtype, device=device, q1d=q1d)
    rng = np.random.default_rng(seed)
    N = f.space.num_nodes
    amp = 3e-3 / round(f.nelem ** (1 / 3)) * scale
    u, v = (torch.as_tensor(rng.standard_normal((3, N)) * amp, dtype=dtype,
                            device=device) for _ in range(2))
    return f, f.compute_qdata(), u, v


def compare(name, got, ref, f64):
    """Raise unless `got` (kernel) agrees with `ref` (float64 plain)."""
    import torch

    err = (got.to(torch.float64) - ref).abs()
    mx = float(ref.abs().max())
    rel = float(err.max()) / mx
    if f64:
        ok = rel <= 1e-12
    else:
        ok = bool((err <= 2e-5 * ref.abs() + 1e-6 * mx).all())
    log(f"    {name:34s} max|ref| {mx:.3e}  max|diff| {float(err.max()):.3e}"
        f"  rel-to-max {rel:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(name)
    return float(err.max())


def misaligned(t):
    """A copy of `t` whose first word lies one word past a 16-byte
    boundary (contiguous): the streams the TMA bulk path refuses."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_kernel(label, mesh, degree, device, phys, qextra=0,
                 physics="hyperFS", q1d=None, shift=False, plans=None,
                 scale=1.0, report="float32", cluster=0, dtypes=None):
    """Kernel vs plain on one mesh/degree (P = degree + 1, Q = P + qextra,
    or q1d), f64 and f32; returns the max abs errors (residual ve, J.v) in
    `report`'s dtype, "float32" or "float64". A physics without a stash
    (linElas) must return none. With `shift` the kernel reads qdata and
    the stash from copies one word off 16 bytes. `plans`, a list, gets the
    launch plan of each of the four launches (fused_apply.plan). `scale`:
    make_case's. `cluster` > 0: the cluster body at that many CTAs a
    cluster (the plan's otherwise); `dtypes`: "float64" or "float32" alone
    (both by default)."""
    import torch

    from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
    from ceedpetscsolid_tpu_torch.ops.basis import Basis3D

    def moved(t):
        return misaligned(t) if shift and t is not None else t

    f, q, u, v = make_case(mesh, degree, torch.float64, device, seed=degree,
                           qextra=qextra, q1d=q1d, scale=scale)
    conn, b64 = f.restr.conn, f.basis
    ve0, st0 = fa.residual_plain(u, conn, q, b64, phys, physics)
    jv0 = fa.jacobian_plain(v, conn, q, st0, b64, phys, physics)
    kw = dict(cluster=cluster)
    e64 = {"residual ve": None, "J.v ve": None}
    if dtypes in (None, "float64"):
        ve, st = fa.residual(u, conn, moved(q), b64, phys, physics, **kw)
        jv = fa.jacobian(v, conn, moved(q), moved(st0), b64, phys, physics,
                         **kw)
        torch.cuda.synchronize()
        if (st is None) != (st0 is None):
            FAILED.append(f"{label}: kernel stash {st is None}, "
                          f"plain {st0 is None}")
        pairs = [("residual ve", ve, ve0), ("stash", st, st0),
                 ("J.v ve", jv, jv0)]
        pairs = [(nm, a, b) for nm, a, b in pairs if b is not None]
        e64 = {nm: compare(f"{label} f64 {nm}", a, b, True)
               for nm, a, b in pairs}
        if plans is not None:
            plans += [fa.plan(False, moved(q), b64, None, physics),
                      fa.plan(True, moved(q), b64, moved(st0), physics)]
    e_r = e_j = None
    if dtypes in (None, "float32"):
        f32 = torch.float32
        b32 = Basis3D.create(b64.P, b64.Q, "gauss", f32, device=device)
        q32 = moved(q.to(f32))
        ve, st = fa.residual(u.to(f32), conn, q32, b32, phys, physics, **kw)
        jv = fa.jacobian(v.to(f32), conn, q32, None if st0 is None else
                         moved(st0.to(f32)), b32, phys, physics, **kw)
        torch.cuda.synchronize()
        if plans is not None:
            st32 = None if st0 is None else moved(st0.to(f32))
            plans += [fa.plan(False, q32, b32, None, physics),
                      fa.plan(True, q32, b32, st32, physics)]
        e_r = compare(f"{label} f32 residual ve", ve, ve0, False)
        if st0 is not None:
            compare(f"{label} f32 stash", st, st0, False)
        e_j = compare(f"{label} f32 J.v ve", jv, jv0, False)
    if report == "float64":
        return e64["residual ve"], e64["J.v ve"]
    return e_r, e_j


def by_coordinates(prob, u):
    """(nodal coordinates, u as (N, 3)) sorted by coordinates, so that two
    numberings of one mesh line up node by node."""
    xyz = np.asarray(prob._coords)
    order = np.lexsort(np.round(xyz, 9).T)
    return xyz[order], u.double().cpu().numpy().T[order]


def run_cli(flags):
    """cli.main(flags) with its standard output captured: (rc, output, the
    problem it solved, its SolveInfo)."""
    from ceedpetscsolid_tpu_torch import cli
    from ceedpetscsolid_tpu_torch.problem import ElasticityProblem

    seen = []
    orig = ElasticityProblem.solve

    def spy(self, *args, **kw):
        info = orig(self, *args, **kw)
        seen.append((self, info))
        return info

    ElasticityProblem.solve = spy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(flags))
    ElasticityProblem.solve = orig
    return (rc, buf.getvalue(), *seen[-1])


def read_vtu(path):
    """(NumberOfPoints, NumberOfCells, {array name: float64 values}) of a
    VTU file of post/vtu.py, parsed with xml.etree (the points' array is
    named "Points")."""
    root = ET.parse(path).getroot()
    piece = root.find("UnstructuredGrid/Piece")
    arrays = {e.get("Name", "Points"): np.array(e.text.split(), float)
              for e in root.iter("DataArray")}
    return (int(piece.get("NumberOfPoints")), int(piece.get("NumberOfCells")),
            arrays)


def gather_phase(dev, card):
    """Phase 9. The probe entry point as a user runs it, launch counts set
    to 0 just before and read just after; then every kernel against its
    plain version on gather_probe.probe_cases; then call and device times
    at the probe's shape and the production-shape gather. Returns the
    entry point's launches, each kernel's max abs difference over the cases,
    its times, the library calls' times (gather_probe.time_library: bare
    tab[idx], the one PyTorch call of the same function for in-range
    indices, and the one-hot matrix product, K6's function as one call),
    each kernel's bound in ms at the probe's shape (gather_probe.bound_ms:
    the table rows the indices touch, all of them for K6, read once, the
    indices read once, the output written once, at 3.35 TB/s) and the
    production-shape numbers (gather_probe.time_production)."""
    import torch

    from ceedpetscsolid_tpu_torch.ops import gather_probe as gp

    gp.COUNTS.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gp.main([])
    launches = dict(gp.COUNTS.launches)
    clusters = dict(gp.COUNTS.cluster_dims)
    log("[9] python -m ceedpetscsolid_tpu_torch.ops.gather_probe -> rc "
        f"{rc}, launches {launches}")
    for line in buf.getvalue().splitlines():
        log("    | " + line)
    if rc != 0 or min(launches.values()) < 1:
        raise AssertionError("gather probe entry point failed")
    log(f"    cluster dimensions of the last launches (K3, K4, K6; 1 block: "
        f"a plain launch): {clusters}")
    if any(clusters.get(k, (1,))[0] < 2 for k in gp.STAGED):
        raise AssertionError(f"K3/K4 did not launch as clusters: {clusters}")
    errs, bad = dict.fromkeys(gp.KINDS, 0.0), []
    for label, tab, idx in gp.probe_cases(dev):
        (W, C), R = tab.shape, idx.shape[0]
        p, op = gp.plan(W, C, R), gp.onehot_plan(W, C, R, C % 4 == 0)
        cmp = gp.compare_probes(tab, idx)
        log(f"    {label:40s} K3/K4 cluster {p.cs} x {C // p.slab} slab(s) x "
            f"{p.groups} group(s), K6 cluster {op.cs} x {op.slabs} x "
            f"{op.groups}: " + ", ".join(
                f"{n} {'equal' if eq else 'DIFFERS'} {e:.1e}"
                for n, (eq, e) in cmp.items()))
        for n, (eq, e) in cmp.items():
            errs[n] = max(errs[n], e)
            if not eq:
                bad.append((label, n))
    if bad:
        raise AssertionError(f"a probe kernel differs from its plain version: "
                             f"{bad}")
    tab, idx = gp.probe_inputs(dev)
    times, lib = gp.time_probes(tab, idx), gp.time_library(tab, idx)
    W, R, C = gp.PROBE_SHAPE
    bounds = {n: gp.bound_ms(tab, idx, whole_table=n == "onehot")
              for n in gp.KINDS}
    log(f"    times at ({W}, {C}) / ({R},) ({card}): one call (host enqueue "
        "included) / device alone; bound from this run's inputs")
    for k, t in lib.items():
        log(f"    {'bare tab[idx]' if k == 'index' else 'onehot @ tab':24s} "
            f"{t['ms']:.4f} / {t['device_ms']:.4f} ms")
    for name, t in times.items():
        log(f"    gather_{name:16s} {t['ms']:.4f} / {t['device_ms']:.4f} ms  "
            f"(plain {t['plain_ms']:.4f} / {t['plain_device_ms']:.4f} ms); "
            f"bound {bounds[name]:.5f} ms, share "
            f"{bounds[name] / t['device_ms']:.3f}")
    prod = gp.time_production(dev)
    Wp, Rp, Cp = gp.PRODUCTION_SHAPE
    log(f"    production ({Rp} rows of {Cp} from ({Wp}, {Cp}), "
        f"{prod['gb']:.4f} GB): gather_loop call {prod['ms']:.4f} ms, device "
        f"{prod['device_ms']:.4f} ms ({prod['gbps']:.1f} GB/s), bound "
        f"{prod['bound_ms']:.4f} ms, share {prod['share']:.3f}; index_select "
        f"call {prod['plain_ms']:.4f} ms, device {prod['plain_device_ms']:.4f}"
        f" ms ({prod['plain_gbps']:.1f} GB/s) ({card})")
    return launches, errs, times, lib, bounds, prod


def owner_sum_cases():
    """Phase 4b's restrictions, as the main paths build them: (label,
    conn, num_nodes, node_ranges). The 24^3 and 28^3 p4 boxes (phase 3's
    and the benchmark's), phase 7's p-MG levels on the 16^3 box (p = 1,
    2), the scrambled 4^3 box at p2, and rank 1's interior and boundary
    batches of the 16^3 p4 box over four ranks (phase 18's partition;
    no node ranges, as parallel/dist.RankArrays builds them)."""
    from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
    from ceedpetscsolid_tpu_torch.mesh.fespace import build_fespace
    from ceedpetscsolid_tpu_torch.mesh.scrambled import scrambled_box_mesh
    from ceedpetscsolid_tpu_torch.parallel.partition import partition_space

    def space(label, mesh, degree):
        s = build_fespace(mesh, degree)
        return label, s.conn, s.num_nodes, s.entity_node_ranges()

    m = SOLVE_BOX
    for n in (KERNEL_BOX, OWNER_SUM_BOX):
        yield space(f"{n}^3 p4 box", box_mesh((n, n, n)), 4)
    for deg in (1, 2):
        yield space(f"{m}^3 p{deg} box (phase 7's level)",
                    box_mesh((m, m, m)), deg)
    yield space("4^3 p2 scrambled", scrambled_box_mesh((4, 4, 4), 4), 2)
    s = build_fespace(box_mesh((m, m, m)), 4)
    part = partition_space(s.conn, s.num_nodes, DIST_WORLD)
    conn = part.conn_local[1][part.elem_valid[1]]
    k = part.n_elem_int
    yield (f"{m}^3 p4 rank 1 of {DIST_WORLD}, restr_int", conn[:k],
           part.n_owned_max, None)
    yield (f"{m}^3 p4 rank 1 of {DIST_WORLD}, restr_bnd", conn[k:],
           part.n_local, None)


def csr_sum(ve, offsets, positions):
    """The owner-sum in the kernel's order, in plain torch on ve's device:
    the k-th position of a node (ascending, from 0) added into running sum
    k mod 4, each started at +0.0, and the node's value (s0 + s1) +
    (s2 + s3) (IEEE additions in ve's dtype, as the kernel makes them)."""
    import torch

    flat = ve.reshape(ve.shape[0], -1)
    offsets, positions = offsets.long(), positions.long()
    counts = offsets[1:] - offsets[:-1]
    acc = torch.zeros((4, ve.shape[0], counts.numel()), dtype=ve.dtype,
                      device=ve.device)
    for k in range(int(counts.max())):
        rows = torch.nonzero(counts > k).squeeze(1)
        acc[k % 4][:, rows] += flat[:, positions[offsets[rows] + k]]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def padded_sum(ve, blocks, zero):
    """The owner-sum as plain torch ran it on the card before the kernel
    (and still runs it on the CPU): ve with a zero column appended, one
    index_select a padded (nodes, K) block, a sum over K."""
    import torch

    ncomp = ve.shape[0]
    ext = torch.cat([ve.reshape(ncomp, -1), zero], dim=1)
    parts = [ext.index_select(1, idx).reshape(ncomp, -1, K).sum(dim=2)
             for K, idx in blocks]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def owner_sum_counts(tag):
    """The owner-sum counters of the last request (utils/timing: a request
    starts them at 0): calls and kernel launches; raises unless every call
    launched the kernel."""
    from ceedpetscsolid_tpu_torch.utils import timing

    counts = timing.records()[-1]["counts"]
    calls = counts.get("restr.owner_sum_calls", 0)
    kernel = counts.get("restr.owner_sum_kernel", 0)
    if not calls or kernel != calls:
        raise AssertionError(f"{tag}: {kernel} owner-sum kernel launches for "
                             f"{calls} owner-sums")
    return kernel


def owner_sum_phase(dev, card):
    """Phase 4b (see the module docstring). Returns the max abs difference
    from the padded plain sum over every case (the kernel equals the
    sum in its order bit for bit, else this raises) and the times at
    OWNER_SUM_BOX p4: {(ncomp, dtype): {ms, device_ms, plain_ms,
    plain_device_ms, library_ms, library_device_ms, bytes, bound_ms}}."""
    import torch

    from ceedpetscsolid_tpu_torch.ops.fused_apply import H100_BYTES_PER_S
    from ceedpetscsolid_tpu_torch.ops.restriction import Restriction
    from ceedpetscsolid_tpu_torch.utils.timing import cuda_device_ms
    from ceedpetscsolid_tpu_torch.utils.timing import cuda_time_ms

    log("[4b] owner-sum kernel (csrc/owner_sum.cu) vs the sum in its order "
        "(bit for bit) and the padded plain sum, components "
        f"{OWNER_SUM_NCOMP}, float32 and float64")
    gen = torch.Generator(device=dev).manual_seed(4)
    err, times, bad = 0.0, {}, []
    for label, conn, n, ranges in owner_sum_cases():
        r = Restriction(conn, n, ranges, device=dev)
        cpu = Restriction(conn, n, ranges, device="cpu")
        blocks = [(K, idx.to(dev)) for K, idx in cpu._t_blocks]
        counts = torch.diff(r.offsets)
        row = []
        for dtype in (torch.float32, torch.float64):
            eps = torch.finfo(dtype).eps
            for ncomp in OWNER_SUM_NCOMP:
                ve = torch.randn((ncomp, *conn.shape), generator=gen,
                                 dtype=dtype, device=dev)
                zero = ve.new_zeros((ncomp, 1))
                got = r.scatter_add(ve)
                want = csr_sum(ve, r.offsets, r.positions)
                same = torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8))
                diff = (got - padded_sum(ve, blocks, zero)).abs()
                # each order errs by at most (K - 1) u sum|v|: 8 eps bounds
                # the two apart at K <= 8
                tol = 8 * eps * csr_sum(ve.abs(), r.offsets, r.positions)
                if not same or (diff > tol).any():
                    bad.append((label, ncomp, str(dtype)))
                err = max(err, float(diff.max()))
                row.append(f"{ncomp}{'d' if dtype == torch.float64 else 'f'}"
                           f" {'equal' if same else 'DIFFERS'}"
                           f" {float(diff.max()):.1e}")
        log(f"    {label:38s} {conn.shape[0]:6d} x {conn.shape[1]:3d}, "
            f"{n:8d} nodes, K {int(counts.min())}-{int(counts.max())}, "
            f"{len(blocks)} padded block(s): " + ", ".join(row))
        if label != f"{OWNER_SUM_BOX}^3 p4 box":
            continue
        for ncomp, dn in OWNER_SUM_TIMED:
            dtype = getattr(torch, dn)
            ve = torch.randn((ncomp, *conn.shape), generator=gen, dtype=dtype,
                             device=dev)
            zero = ve.new_zeros((ncomp, 1))
            idx = r.conn.reshape(-1)
            flat = ve.reshape(ncomp, -1)
            calls = {
                "": lambda: r.scatter_add(ve),
                "plain_": lambda: padded_sum(ve, blocks, zero),
                "library_": lambda: torch.zeros(
                    (ncomp, n), dtype=dtype, device=dev).index_add_(
                        1, idx, flat)}
            t = {}
            for k, fn in calls.items():
                t[k + "ms"] = cuda_time_ms(fn)
                t[k + "device_ms"] = cuda_device_ms(fn)
            t["bytes"] = (ve.numel() * ve.element_size()
                          + ncomp * n * ve.element_size()
                          + 4 * (r.positions.numel() + r.offsets.numel()))
            t["bound_ms"] = 1e3 * t["bytes"] / H100_BYTES_PER_S
            times[(ncomp, dn)] = t
        del ve, zero, flat, idx, calls
    if bad:
        raise AssertionError(f"owner-sum kernel disagrees: {bad}")
    log(f"    times at {OWNER_SUM_BOX}^3 p4 ({card}): one call (host enqueue "
        "included) / device alone, median of 20 (warm L2: the same input "
        "each call); bound: the bytes read and written once at 3.35 TB/s")
    for (ncomp, dn), t in times.items():
        log(f"    {ncomp} comp {dn:7s} kernel {t['ms']:.4f} / "
            f"{t['device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bytes'] / 1e6:.1f} MB), share "
            f"{t['bound_ms'] / t['device_ms']:.3f}; padded plain "
            f"{t['plain_ms']:.4f} / {t['plain_device_ms']:.4f} ms; "
            f"index_add_ {t['library_ms']:.4f} / "
            f"{t['library_device_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return err, times


def dist_launch_check(tag, out, jobs):
    """Every rank launched the fused kernel in each job, by kernel paths
    only, once per batch apply (so no batch ran the plain version); print
    each rank's launches by path."""
    for job, modes in jobs:
        for r, c in enumerate(out[job + "_counts"]):
            log(f"    {tag} rank {r} {job}: launches {c['launches']}, batch "
                f"applies {c['batch_applies']}, by path "
                + ", ".join(f"{m} {p} {n}"
                            for (m, p), n in sorted(c["by_path"].items())))
            if not (set(p for _, p in c["by_path"]) <= KERNEL_PATHS
                    and all(c["launches"][m] == c["batch_applies"][m] > 0
                            for m in modes)):
                raise AssertionError(f"{tag} rank {r} {job}: a batch ran "
                                     "without the fused kernel")


def dist_phase(dev, card, exo, phase11, parts="abcd"):
    """Phase 18 (see the module docstring). exo: phase 16's HEX27 file;
    phase11: (SNES, KSP) of phase 11's native-level solve; parts: which of
    (a)-(d) to run after the serial reference (all, as main() runs it).
    Returns rank 0's launches by (physics, mode, P, Q) over (b)'s jobs."""
    import torch
    import torch.distributed as tdist

    from ceedpetscsolid_tpu_torch.parallel import launch, tasks
    from ceedpetscsolid_tpu_torch.problem import Config, ElasticityProblem

    t18 = time.perf_counter()
    store = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dist"
    store.mkdir(parents=True, exist_ok=True)
    cfg = dict(DIST_CONFIG, dtype=torch.float32)

    def zero_residual_norm(prob):
        u0 = torch.zeros((3, prob.fine_space.num_nodes), dtype=prob.dtype,
                         device=dev)
        G, _ = prob._nonlinear_residual(u0, prob.bc_values(1.0), prob.F)
        return float(torch.linalg.norm(G.double()))

    prob = ElasticityProblem(Config(**cfg, device=dev))
    prob.config.newton.rtol = DIST_RTOL
    g_ref = zero_residual_norm(prob)
    info = prob.solve()
    u_ref = info.u.double().cpu().numpy()
    log(f"[18] serial reference: hyperFS p4 {cfg['box_faces'][0]}^3 "
        f"float32, p-MG {prob.level_degrees} + AMG at the fine level "
        f"quadrature, Newton "
        f"rtol {DIST_RTOL}: SNES {info.snes_iters}, KSP {info.ksp_iters}, "
        f"solve {info.solve_time:.3f} s; phase 11 (native levels, Newton "
        f"rtol 1e-6): SNES {phase11[0]}, KSP {phase11[1]} ({card})")
    del prob
    jobs = [("residual", (None, 1.0)), ("solve", {"rtol": DIST_RTOL})]

    def check(tag, out):
        g = float(np.linalg.norm(out["residual"].astype(np.float64)))
        rel = abs(g - g_ref) / g_ref
        s = out["solve"]["info"]
        u = out["solve"]["u"].astype(np.float64)
        du = float(np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref))
        steps = s["step_seconds"]
        ex = s["exchange_seconds"]
        share = sum(ex.values()) / max(sum(steps), 1e-30)
        per_it = ((sum(steps) - sum(s["pc_seconds"]))
                  / max(s["ksp_iters"], 1) * 1e3)
        setup = out["setup"][0]
        log(f"{tag} |G(0)| {g:.9e} vs serial {g_ref:.9e} (rel {rel:.2e}); "
            f"converged {s['converged']} ({s['reason']}), SNES "
            f"{s['newton_iters']}, KSP {s['ksp_iters']}, rnorm "
            f"{s['rnorm']:.3e}, |u - u_serial| / |u_serial| {du:.2e}")
        log(f"    solve {s['wall_s']:.3f} s; wall per Newton step "
            + ", ".join(f"{t:.3f}" for t in steps) + " s; seconds in the "
            "exchanges (rank 0, the "
            + ("device's" if "NCCL" in tag else "host's") + ") " + ", ".join(
                f"{k} {v:.3f}" for k, v in ex.items())
            + f": {100 * share:.1f}% of the steps; preconditioner setup "
            + ", ".join(f"{t:.3f}" for t in s["pc_seconds"])
            + f" s; wall per CG iteration (steps less setups, over KSP) "
            f"{per_it:.3f} ms ({card})")
        log(f"    setup (rank 0): ElasticityProblem {setup['problem_s']:.2f} "
            f"s, DistributedProblem {setup['distributed_s']:.2f} s, of it "
            "partition_space " + ", ".join(
                f"p{d} {t:.3f} s" for d, t in
                sorted(setup["partition_s"].items())) + f" ({card})")
        log(f"    halo {out['halo']}; interior elements a level "
            f"{out['n_elem_int'][0]}")
        dist_launch_check(tag, out, [("residual", ("residual",)),
                                     ("solve", ("residual", "jacobian"))])
        if not (rel <= DIST_TOL and s["converged"]
                and s["newton_iters"] == info.snes_iters
                and s["ksp_iters"] <= info.ksp_iters + 2
                and du <= DIST_TOL):
            raise AssertionError(f"{tag} the distributed solve disagrees "
                                 "with the serial one")
        return s

    if "a" in parts:
        # one NCCL rank in this process
        t0 = time.perf_counter()
        tdist.init_process_group("nccl", store=tdist.FileStore(
            str(store / f"nccl1_{os.getpid()}"), 1), rank=0, world_size=1)
        try:
            a = tasks.problem_task(0, 1, dev, cfg, jobs)
        finally:
            tdist.destroy_process_group()
        sa = check("[18a] NCCL, 1 rank:", a)
        log(f"    (a) {time.perf_counter() - t0:.1f} s ({card})")
    counts = {}
    if "b" in parts:
        # four gloo ranks on this card
        t0 = time.perf_counter()
        b = launch.run(tasks.problem_task, DIST_WORLD, "gloo", dev, store,
                       args=(cfg, jobs))
        sb = check(f"[18b] gloo, {DIST_WORLD} ranks on {dev}:", b)
        vs = (f"vs (a): SNES {sb['newton_iters']} / {sa['newton_iters']}, "
              f"KSP {sb['ksp_iters']} / {sa['ksp_iters']}; "
              if "a" in parts else "")
        log(f"    {vs}(b) {time.perf_counter() - t0:.1f} s ({card})")
        for job in ("residual", "solve"):
            for key, n in b[job + "_counts"][0]["by_physics"].items():
                counts[key] = counts.get(key, 0) + n

    # (c) one Newton step of the composite and the unstructured variants
    variants = (
        ("composite", dict(problem="hyperFSIncomp", degree=2, nu=0.3, E=1.0,
                           test_mode=True, box_faces=(3, 3, 3),
                           multigrid="logarithmic", num_increments=1,
                           dtype=torch.float64)),
        ("unstructured", dict(problem="hyperFS", degree=2, nu=0.3, E=1.0,
                              test_mode=True, mesh_file=str(exo),
                              multigrid="logarithmic", num_increments=1,
                              dtype=torch.float64)))
    for label, vcfg in variants if "c" in parts else ():
        t0 = time.perf_counter()
        g_v = zero_residual_norm(ElasticityProblem(Config(**vcfg,
                                                          device=dev)))
        out = launch.run(tasks.problem_task, DIST_WORLD, "gloo", dev, store,
                         args=(vcfg, [("step", (None, 1.0))]))
        st = out["step"]
        rel = abs(st["rnorm_in"] - g_v) / g_v
        log(f"[18c] {label} ({vcfg['problem']} p2, float64, {DIST_WORLD} "
            f"gloo ranks): |G_in| {st['rnorm_in']:.6e} -> |G_out| "
            f"{st['rnorm']:.6e}, CG {st['iters']}, serial parity {rel:.2e}, "
            f"halo {out['halo']['total_ghosts']} ghosts; "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        dist_launch_check(f"[18c] {label}", out,
                          [("step", ("residual", "jacobian"))])
        if not (rel <= DIST_TOL and st["rnorm"] < st["rnorm_in"]):
            raise AssertionError(f"[18c] {label}: no parity or no progress")

    # (d) four NCCL ranks, one a card
    n_cards = torch.cuda.device_count()
    if "d" in parts and n_cards >= DIST_WORLD:
        t0 = time.perf_counter()
        d = launch.run(tasks.problem_task, DIST_WORLD, "nccl", "cuda", store,
                       args=(cfg, jobs))
        check(f"[18d] NCCL, {DIST_WORLD} ranks on {DIST_WORLD} cards:", d)
        log(f"    (d) {time.perf_counter() - t0:.1f} s ({card})")
    elif "d" in parts:
        log(f"[18d] NCCL on {DIST_WORLD} cards: not run, this machine has "
            f"{n_cards} card(s)")
    log(f"    phase 18 {time.perf_counter() - t18:.1f} s ({card})")
    return counts

def log_weak(rec, note=""):
    """A weak point's numbers on two or three lines."""
    st = rec["setup_s"]

    def parts(phase):
        return f"{phase} {st.get(phase, 0.0):.3f} (" + ", ".join(
            f"{k.split(': ')[1]} {v:.3f}" for k, v in st.items()
            if k.startswith(phase + ": ")) + ")"
    log(f"[20] {rec['series']} n = {rec['n']} {rec['backend']}{note}: "
        f"{rec['dofs']} DoF, {rec['elements_per_rank']} elements a rank, "
        f"halo {rec['halo_per_rank']} ({rec['halo_max_bytes_f32']} B f32 "
        f"max), CG {rec['ksp_its']}; step ms min / median / max "
        f"{rec['step_ms_min']:.3f} / {rec['step_ms_median']:.3f} / "
        f"{rec['step_ms_max']:.3f}; exchanges a step ({rec['clock']} clock) "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["exchange_ms"].items())
        + f" ms ({rec['card']})")
    log(f"    setup s (rank 0): {parts('refresh_amg')}, {parts('pc_setup')}"
        f"; ElasticityProblem "
        f"{max(rec['problem_s']):.2f}, DistributedProblem "
        f"{max(rec['distributed_s']):.2f} (max over ranks); fused launches "
        "by rank " + ", ".join(f"{c['residual']}/{c['jacobian']}"
                               for c in rec["launches"]))
    prof = rec["profile"]
    if prof:
        log(f"    profile (rank 0, one step): {prof['launches']} launches, "
            f"device {prof['device_ms']:.3f} ms, busy {prof['busy_ms']:.3f}"
            f" ms = {prof['busy_share']:.3f} of the median step; "
            + ", ".join(f"{k} {v['launches']} / {v['ms']:.3f} ms"
                        for k, v in prof["families"].items())
            + "; host calls " + ", ".join(
                f"{k} {v['calls']} / {v['ms']:.3f} ms"
                for k, v in prof["host"].items())
            + f"; profiled step {prof['wall_ms']:.3f} ms")


def log_invariance(rec):
    ser = rec["serial"]
    log(f"[20] invariance n = {rec['n']} {rec['backend']}: SNES "
        f"{rec['snes']} / serial {ser['snes']}, KSP {rec['ksp']} / "
        f"{ser['ksp']}, rnorm {rec['rnorm']:.3e}, |u - u_serial| / "
        f"|u_serial| {rec['rel_du']:.2e}, solve {rec['wall_s']:.3f} s "
        f"(serial {ser['wall_s']:.3f} s), halo max {rec['halo_max']} "
        f"({rec['card']})")


def sweep_phase(card, full=False):
    """Phase 20 (see the module docstring); full: --phase20's sweep.
    Raises listing every failed check."""
    import torch

    from ceedpetscsolid_tpu_torch.utils import weak_scaling as ws

    t20 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke" / "weak"
    store = root / "store"
    f32 = torch.float32
    failures, records, summaries = [], [], []
    n_cards = torch.cuda.device_count()
    ranks = [n for n in (1, 2, 4) if n <= n_cards] if full else [1]
    if full and len(ranks) < 3:
        log(f"[20] n = {[n for n in (1, 2, 4) if n > n_cards]} not run: "
            f"NCCL runs one rank a card and this machine has {n_cards}")
    reps = SWEEP_FULL_REPS if full else SWEEP_REPS

    def weak(series, n, backend, note=""):
        rec = ws.weak_point(series, n, backend, "cuda", store, reps,
                            profile=full, dtype=f32,
                            in_process=not full and backend == "nccl",
                            card_name=card)
        log_weak(rec, note)
        failures.extend(ws.weak_failures(rec, on_card=True))
        records.append(rec)
        return rec

    for series in ws.WEAK if full else ("jax",):
        recs = [weak(series, n, "nccl") for n in ranks
                if series != "unstructured" or n in ws.UNSTRUCTURED_RANKS]
        if not full:
            weak(series, 2, "gloo", " on one card (host staging, not a "
                 "scaling point)")
            continue
        sm = ws.weak_summary(recs)
        summaries.append(sm)
        log(f"[20] {series} summary (NCCL, one rank a card): " + "; ".join(
            f"n = {p['n']} E {p['efficiency']:.3f}, "
            f"{p['dofs_per_s_card']:.4g} DoF/s a card"
            for p in sm["points"]) + f"; halo constant {sm['halo_constant']}"
            f" ({card})")
        if series != "unstructured" and not sm["halo_constant"]:
            failures.append(f"{series}: the halo a rank is not constant for "
                            "n > 1")

    cfg = ws.invariance_config(f32, root / "meshes")
    serial, u_ser = ws.invariance_serial(cfg, torch.device("cuda"))
    inv = [("nccl", n, not full) for n in ranks]
    if not full:
        inv.append(("gloo", 2, False))
    recs = []
    for backend, n, in_process in inv:
        rec = ws.invariance_point(cfg, n, backend, "cuda", store, serial,
                                  u_ser, in_process=in_process,
                                  card_name=card)
        rec.pop("u")
        log_invariance(rec)
        failures.extend(ws.invariance_failures(rec, DIST_TOL, on_card=True))
        records.append(rec)
        recs.append(rec)
    if full:
        sm = ws.invariance_summary(recs)
        summaries.append(sm)
        log("[20] invariance: strong-scaling speedup wall(1) / wall(n) "
            + ", ".join(f"n = {p['n']} {p['speedup']:.3f}"
                        for p in sm["points"]) + f" ({card})")
    root.mkdir(parents=True, exist_ok=True)
    (root / ("phase20_full.json" if full else "phase20.json")).write_text(
        json.dumps({"card": card, "records": records,
                    "summaries": summaries}, indent=1) + "\n")
    log(f"    phase 20 {time.perf_counter() - t20:.1f} s ({card})")
    if failures:
        raise AssertionError("[20] " + "; ".join(failures))


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on a GPU", file=sys.stderr)
        return 2
    if importlib.util.find_spec("ceedpetscsolid_tpu_torch") is None:
        print("chip_smoke: package ceedpetscsolid_tpu_torch not found beside "
              "this script", file=sys.stderr)
        return 3
    from ceedpetscsolid_tpu_torch import cli, native
    from ceedpetscsolid_tpu_torch.csrc.build import build
    from ceedpetscsolid_tpu_torch.mesh.box import box_mesh
    from ceedpetscsolid_tpu_torch.mesh.scrambled import (
        faces_on, scrambled_box_mesh, write_exodus_hex27)
    from ceedpetscsolid_tpu_torch.models import Physics
    from ceedpetscsolid_tpu_torch.ops import fused_apply as fa
    from ceedpetscsolid_tpu_torch.post.vtu import write_vtu
    from ceedpetscsolid_tpu_torch.problem import (
        Config, ElasticityProblem, select_device)
    from ceedpetscsolid_tpu_torch.solve import newton as newton_mod
    from ceedpetscsolid_tpu_torch.utils.profile_solve import make_problem
    from ceedpetscsolid_tpu_torch.utils.timing import (
        cuda_device_ms as device_ms)
    from ceedpetscsolid_tpu_torch.utils.timing import cuda_time_ms as time_ms

    dev = select_device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    # ---- 1. card --------------------------------------------------------
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}  CUDA {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    # the native AMG library (g++) builds beside the CUDA kernels (parallel
    # nvcc), so no solve below times its first-use build
    def build_native():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        amg_build = pool.submit(build_native)
        lib, ptx = build()
    amg_lib, amg_s = amg_build.result()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptx)]
    spills = [ln.strip() for ln in ptx.splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    log(f"[2] kernel build {time.perf_counter() - t0:.1f} s -> {lib.name}: "
        f"{len(regs)} kernels, registers {min(regs, default=0)}-"
        f"{max(regs, default=0)}, {len(spills)} with spills")
    for line in spills:
        log("    " + line)
    log(f"    native AMG library {amg_lib.name}: {amg_s:.1f} s (g++, "
        "beside the kernel build)")

    # ---- 3. kernel vs plain ---------------------------------------------
    phys = Physics(nu=0.3, E=1.0)
    log("[3] kernel vs plain version")
    fa.COUNTS.reset()
    n = KERNEL_BOX
    errs = check_kernel(f"{n}^3 p4 box", box_mesh((n, n, n)), 4, dev, phys)
    for deg in (2, 3):
        errs += check_kernel(f"4^3 p{deg} box", box_mesh((4, 4, 4)), deg, dev,
                             phys)
        errs += check_kernel(f"4^3 p{deg} scrambled",
                             scrambled_box_mesh((4, 4, 4), 4), deg, dev, phys)
    m = SOLVE_BOX
    for deg in (1, 2):      # phase 7's p = 1 and p = 2 levels, (2,2), (3,3)
        errs += check_kernel(f"{m}^3 p{deg} box", box_mesh((m, m, m)), deg,
                             dev, phys)
    for label, faces, deg, shift in EDGE_CASES:
        errs += check_kernel(label, box_mesh(faces), deg, dev, phys,
                             shift=shift)
        # hyperSS's J.v reads its stash from global memory, not staged
        check_kernel(f"{label} hyperSS", box_mesh(faces), deg, dev, phys,
                     physics="hyperSS", shift=shift)
    paths = dict(fa.COUNTS.by_path)
    log(f"    launches per copy path: {paths}")
    if min(paths.get((m_, p_), 0) for m_ in ("residual", "jacobian")
           for p_ in ("bulk", "async")) < 1:
        raise AssertionError(f"a copy path did not run in both modes: {paths}")
    log("[3b] P < Q instances vs plain version")
    k = FINE_LEVEL_BOX
    for P, Q in PQ_LESS:
        for label, mesh in (("box", box_mesh((4, 4, 4))),
                            ("scrambled", scrambled_box_mesh((4, 4, 4), 4))):
            errs += check_kernel(f"4^3 (P,Q)=({P},{Q}) {label}", mesh,
                                 P - 1, dev, phys, qextra=Q - P)
        if Q == 5:          # phase 8's fine-quadrature levels
            errs += check_kernel(f"{k}^3 (P,Q)=({P},{Q}) box",
                                 box_mesh((k, k, k)), P - 1, dev, phys,
                                 qextra=Q - P)
    if FAILED:
        raise AssertionError(f"kernel disagrees with plain version: {FAILED}")
    log(f"    times at {m}^3, float32 ({card}):")
    for P, Q in PQ_LESS:
        f, q, u, v = make_case(box_mesh((m, m, m)), P - 1, torch.float32, dev,
                               P, qextra=Q - P)
        conn, b = f.restr.conn, f.basis
        _, st = fa.residual_plain(u, conn, q, b, phys)
        t = [time_ms(lambda: fa.residual(u, conn, q, b, phys)),
             time_ms(lambda: fa.residual_plain(u, conn, q, b, phys)),
             time_ms(lambda: fa.jacobian(v, conn, q, st, b, phys)),
             time_ms(lambda: fa.jacobian_plain(v, conn, q, st, b, phys))]
        log(f"    (P,Q)=({P},{Q}) residual {t[0]:.4f} ms (plain {t[1]:.4f} ms)"
            f", J.v {t[2]:.4f} ms (plain {t[3]:.4f} ms)")
    del f, q, u, v, st

    # ---- 3c. the other physics vs plain version -----------------------------
    log("[3c] linElas, hyperSS, hyperFSIncomp (mu part, pressure part) vs "
        "plain version")
    perr = {}           # physics -> f32 max abs errors (residual, J.v, ...)
    for ph in NEW_PHYSICS:
        perr[ph] = check_kernel(f"{n}^3 p4 box {ph}", box_mesh((n, n, n)), 4,
                                dev, phys, physics=ph)
        for deg in (2, 3):
            perr[ph] += check_kernel(f"4^3 p{deg} box {ph}",
                                     box_mesh((4, 4, 4)), deg, dev, phys,
                                     physics=ph)
            perr[ph] += check_kernel(f"4^3 p{deg} scrambled {ph}",
                                     scrambled_box_mesh((4, 4, 4), 4), deg,
                                     dev, phys, physics=ph)
    perr[PRESSURE] = ()
    for P in range(2, 6):
        for label, mesh in (("box", box_mesh((4, 4, 4))),
                            ("scrambled", scrambled_box_mesh((4, 4, 4), 4))):
            perr[PRESSURE] += check_kernel(
                f"4^3 (P,Q)=({P},1) {label} pressure", mesh, P - 1, dev,
                phys, physics=PRESSURE, q1d=1)
    if FAILED:
        raise AssertionError(f"kernel disagrees with plain version: {FAILED}")
    ptimes = {}
    log(f"    times at {n}^3 p4, float32 ({card}): call (host enqueue "
        "included) / device alone")
    for ph in (*NEW_PHYSICS, PRESSURE):
        f, q, u, v = make_case(box_mesh((n, n, n)), 4, torch.float32, dev, 4,
                               q1d=1 if ph == PRESSURE else None)
        conn, b = f.restr.conn, f.basis
        _, st = fa.residual_plain(u, conn, q, b, phys, ph)
        calls = {
            "residual": lambda: fa.residual(u, conn, q, b, phys, ph),
            "residual_plain": lambda: fa.residual_plain(u, conn, q, b, phys,
                                                        ph),
            "jacobian": lambda: fa.jacobian(v, conn, q, st, b, phys, ph),
            "jacobian_plain": lambda: fa.jacobian_plain(v, conn, q, st, b,
                                                        phys, ph),
        }
        t = {k: time_ms(fn) for k, fn in calls.items()}
        d = {k: device_ms(fn, reps=10, inner=1) for k, fn in calls.items()}
        bounds = {mode: fa.bound_ms(ph, mode, b.P, b.Q, f.nelem,
                                    f.space.num_nodes, torch.float32)
                  for mode in ("residual", "jacobian")}
        ptimes[ph] = (t, d, bounds)
        for mode in ("residual", "jacobian"):
            bd, by = bounds[mode]
            log(f"    {ph:24s} ({b.P},{b.Q}) {mode:8s} {t[mode]:.4f} / "
                f"{d[mode]:.4f} ms  (plain {t[mode + '_plain']:.4f} / "
                f"{d[mode + '_plain']:.4f} ms)  bound {bd:.4f} ms ({by}), "
                f"share {bd / d[mode]:.3f}")
        del f, q, u, v, st, calls
    torch.cuda.empty_cache()

    # ---- 3d. the generic tile vs plain version -----------------------------
    log("[3d] the generic tile (P, Q at run time) vs plain version")
    fa.COUNTS.reset()
    gplans = []
    for P in range(2, 6):
        for Q in (2, 3):
            for label, mesh in (("box", box_mesh((4, 4, 4))),
                                ("scrambled",
                                 scrambled_box_mesh((4, 4, 4), 4))):
                check_kernel(f"4^3 (P,Q)=({P},{Q}) {label} pressure",
                             mesh, P - 1, dev, phys, physics=PRESSURE, q1d=Q,
                             plans=gplans)
    for P, Q in GENERIC_PQ:
        for ph in ("hyperFS", "linElas"):
            check_kernel(f"3^3 (P,Q)=({P},{Q}) box {ph}",
                         box_mesh((3, 3, 3)), P - 1, dev, phys, physics=ph,
                         q1d=Q, plans=gplans)
    check_kernel("1^3 (P,Q)=(10,10) box", box_mesh((1, 1, 1)), 9, dev, phys,
                 q1d=10, plans=gplans)
    # the tile's edges: one element, and tiles of more than one element
    # whose last is ragged (GENERIC_EDGES)
    for label, faces, P, Q, ph, shift in GENERIC_EDGES:
        check_kernel(f"{label} (P,Q)=({P},{Q}) {ph}", box_mesh(faces),
                     P - 1, dev, phys, physics=ph, q1d=Q, plans=gplans,
                     shift=shift)

    def scale(P):
        """make_case's amplitude factor: (5 / P)^2 above the register
        bodies' cap (a random nodal field's gradient grows with P^2)."""
        return (5 / P) ** 2 if P > fa.GENERIC_REG_CAP else 1.0

    # the cluster body (CLUSTER_EDGES) and the gmem body (GMEM_EDGES), f64
    # and f32; the cluster body one cluster an element at the plan's size,
    # the gmem body's persistent grid a ragged round
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for label, faces, P, Q, ph, shift in CLUSTER_EDGES + GMEM_EDGES:
        before = len(gplans)
        check_kernel(f"{label} (P,Q)=({P},{Q}) {ph}", box_mesh(faces),
                     P - 1, dev, phys, physics=ph, q1d=Q, plans=gplans,
                     shift=shift, scale=scale(P))
        nelem = math.prod(faces)
        for p_ in gplans[before:]:
            if p_.body == "gmem" and not (
                    p_.tiles == min(nelem, fa.GMEM_BLOCKS_PER_SM * sms)
                    and p_.work > 0):
                raise AssertionError(f"{label} gmem plan {p_}")
            if p_.body == "cluster" and not (
                    p_.clusters == nelem and p_.tiles == nelem * p_.cluster
                    and 1 <= p_.cluster <= fa.CLUSTER_MAX
                    and p_.smem <= optin and p_.work == 0):
                raise AssertionError(f"{label} cluster plan {p_}")
    # the gmem body's times at its 7^3 edge, which no main path launches:
    # device ms beside the plain version's and the bound from shapes
    box, P = GMEM_EDGES[-1][1], GMEM_EDGES[-1][2]
    f, q, u, v = make_case(box_mesh(box), P - 1, torch.float64, dev, 7,
                           q1d=P, scale=scale(P))
    conn, b = f.restr.conn, f.basis
    _, st = fa.residual_plain(u, conn, q, b, phys, "hyperFS")
    calls = {"residual": (lambda: fa.residual(u, conn, q, b, phys, "hyperFS"),
                          lambda: fa.residual_plain(u, conn, q, b, phys,
                                                    "hyperFS")),
             "jacobian": (lambda: fa.jacobian(v, conn, q, st, b, phys,
                                              "hyperFS"),
                          lambda: fa.jacobian_plain(v, conn, q, st, b, phys,
                                                    "hyperFS"))}
    for mode, (kernel, plain) in calls.items():
        d, d0 = (device_ms(fn, reps=5, inner=1) for fn in (kernel, plain))
        bd, by = fa.bound_ms("hyperFS", mode, P, P, f.nelem,
                             f.space.num_nodes, torch.float64)
        log(f"    gmem body hyperFS ({P},{P}) f64 {box[0]}^3 {mode}: device "
            f"{d:.4f} ms (plain {d0:.4f} ms), bound {bd:.4f} ms ({by}), "
            f"share {bd / d:.3f} ({card})")
    del f, q, u, v, st, calls
    torch.cuda.empty_cache()
    ragged = [p_ for p_ in gplans if p_.body == "gmem"
              and p_.tiles == fa.GMEM_BLOCKS_PER_SM * sms]
    log(f"    gmem persistent grids of {fa.GMEM_BLOCKS_PER_SM * sms} blocks "
        f"over 343 elements: {len(ragged)} launches")
    ks = sorted({p_.cluster for p_ in gplans if p_.body == "cluster"})
    log(f"    cluster sizes the plans chose: {ks}")
    if FAILED:
        raise AssertionError(f"kernel disagrees with plain version: {FAILED}")
    paths = dict(fa.COUNTS.by_path)
    log(f"    launches per path: {paths}")
    if set(paths) != {(m_, p_) for m_ in ("residual", "jacobian")
                      for p_ in ("generic", "generic_cluster",
                                 "generic_gmem")}:
        raise AssertionError(f"phase 3d ran another path: {paths}")
    if not ragged:
        raise AssertionError("phase 3d ran no ragged persistent gmem grid")
    bodies = sorted({(p.body, p.copy) for p in gplans}, key=str)
    edges = sorted({(p.body, p.elems > 1, p.tiles < torch.cuda.
                     get_device_properties(dev).multi_processor_count)
                    for p in gplans}, key=str)
    log(f"    bodies and copy paths that ran: {bodies}")
    log(f"    (body, elements a tile > 1, fewer tiles than SMs): {edges}")
    regs = [b_ for b_ in fa.GENERIC_BODIES.values()
            if b_ not in ("smem", "gmem", "cluster")]
    need_bodies = {("cluster", None), ("gmem", None)} | {
        (b_, c_) for b_ in regs for c_ in ("bulk", "async")}
    need_edges = {(b_, m_, not m_) for b_ in regs for m_ in (True, False)}
    if not need_bodies <= set(bodies) or not need_edges <= set(edges):
        raise AssertionError(f"phase 3d missed a body, copy path or edge: "
                             f"{bodies}, {edges}")
    gtimes3d = {}
    log(f"    times ({card}): call (host enqueue included) / device "
        "alone; the solves' shapes, then 24^3 and 12^3")
    for ph, box, P, Q, modes, dname in GENERIC_TIMED:
        # the shape's own agreement first: its row reports this error
        errs = check_kernel(f"{box}^3 (P,Q)=({P},{Q}) {ph}",
                            box_mesh((box,) * 3), P - 1, dev, phys,
                            physics=ph, q1d=Q, scale=scale(P),
                            report=dname)
        if FAILED:
            raise AssertionError("kernel disagrees with plain version: "
                                 f"{FAILED}")
        dtype = getattr(torch, dname)
        f, q, u, v = make_case(box_mesh((box,) * 3), P - 1, dtype, dev, P,
                               q1d=Q, scale=scale(P))
        conn, b = f.restr.conn, f.basis
        _, st = fa.residual_plain(u, conn, q, b, phys, ph)
        calls = {
            "residual": lambda: fa.residual(u, conn, q, b, phys, ph),
            "residual_plain": lambda: fa.residual_plain(u, conn, q, b, phys,
                                                        ph),
            "jacobian": lambda: fa.jacobian(v, conn, q, st, b, phys, ph),
            "jacobian_plain": lambda: fa.jacobian_plain(v, conn, q, st, b,
                                                        phys, ph),
        }
        calls = {k: fn for k, fn in calls.items()
                 if k.removesuffix("_plain") in modes}
        t = {k: time_ms(fn) for k, fn in calls.items()}
        d = {k: device_ms(fn, reps=10, inner=1) for k, fn in calls.items()}
        bounds = {mode: fa.bound_ms(ph, mode, b.P, b.Q, f.nelem,
                                    f.space.num_nodes, dtype)
                  for mode in modes}
        plans = {mode: fa.plan(mode == "jacobian", q, b,
                               st if mode == "jacobian" else None, ph)
                 for mode in modes}
        # the cluster body also at the fewest CTAs that fit, twice and four
        # times as many (within 8), each held against the plain version
        # first
        by_k = {}
        w = dtype.itemsize
        k0 = fa.cluster_fewest(P, Q, w)
        for k in ((k0, 2 * k0, 4 * k0) if plans[modes[0]].body == "cluster"
                  else ()):
            if k > fa.CLUSTER_MAX:
                continue
            check_kernel(f"{box}^3 (P,Q)=({P},{Q}) {ph} k={k}",
                         box_mesh((box,) * 3), P - 1, dev, phys, physics=ph,
                         q1d=Q, scale=scale(P), cluster=k, dtypes=dname)
            if FAILED:
                raise AssertionError("kernel disagrees with plain version: "
                                     f"{FAILED}")
            kcalls = {
                "residual": lambda: fa.residual(u, conn, q, b, phys, ph,
                                                cluster=k),
                "jacobian": lambda: fa.jacobian(v, conn, q, st, b, phys, ph,
                                                cluster=k)}
            by_k[k] = {}
            for mode in modes:
                g = fa.generic_plan(P, Q, dtype, f.nelem, sms, 19 if mode ==
                                    "jacobian" else 10, cluster=k)
                dk = device_ms(kcalls[mode], reps=10, inner=1)
                by_k[k][mode] = {"device_ms": dk,
                                 "bound_share": bounds[mode][0] / dk,
                                 "smem": g.smem, "clusters": g.clusters}
        gtimes3d[(ph, b.P, b.Q, box)] = (t, d, bounds, plans, errs, dname,
                                         by_k)
        for mode in modes:
            bd, by = bounds[mode]
            p = plans[mode]
            log(f"    {ph:24s} ({b.P},{b.Q}) {box}^3 {dname} {mode:8s} "
                f"{t[mode]:.4f} / {d[mode]:.4f} ms  (plain "
                f"{t[mode + '_plain']:.4f} / {d[mode + '_plain']:.4f} ms)  "
                f"bound {bd:.4f} ms ({by}), share {bd / d[mode]:.3f}; "
                f"{p.body} {p.copy}: {p.elems} element(s) x {p.tiles} "
                f"tiles, {p.threads} threads, {p.smem} bytes, workspace "
                f"{p.work} bytes" + (f", k={p.cluster} x {p.clusters} "
                                     "clusters" if p.cluster else ""))
            for k, x in by_k.items():
                x = x[mode]
                log(f"        at k={k}: {x['device_ms']:.4f} ms device, share "
                    f"{x['bound_share']:.3f}; {x['smem']} bytes a CTA x "
                    f"{k * x['clusters']} CTAs, {x['clusters']} clusters")
        del f, q, u, v, st, calls
    torch.cuda.empty_cache()

    # ---- 4. times at the 24^3 degree-4 shapes, float32 ----------------------
    f, q, u, v = make_case(box_mesh((n, n, n)), 4, torch.float32, dev, 4)
    conn, b = f.restr.conn, f.basis
    _, st = fa.residual_plain(u, conn, q, b, phys)
    ndof = 3 * f.space.num_nodes
    res_op = f.make_residual_structured("hyperFS", phys)
    jac_op = f.make_jacobian_structured("hyperFS", phys)
    calls = {
        "residual": lambda: fa.residual(u, conn, q, b, phys),
        "residual_plain": lambda: fa.residual_plain(u, conn, q, b, phys),
        "jacobian": lambda: fa.jacobian(v, conn, q, st, b, phys),
        "jacobian_plain": lambda: fa.jacobian_plain(v, conn, q, st, b, phys),
        "residual_operator": lambda: res_op(u, q),
        "jacobian_operator": lambda: jac_op(v, q, st),
    }
    times = {k: time_ms(fn) for k, fn in calls.items()}
    # one call a sample: the plain versions launch so many kernels that ten
    # fill the launch queue, and the host then waits on the held stream
    dtimes = {k: device_ms(calls[k], reps=10, inner=1) for k in
              ("residual", "residual_plain", "jacobian", "jacobian_plain")}
    bounds = {mode: fa.bound_ms("hyperFS", mode, b.P, b.Q, f.nelem,
                                f.space.num_nodes, torch.float32)
              for mode in ("residual", "jacobian")}
    log(f"[4] times at {n}^3 p4, float32, {ndof} DoF ({card})")
    for k, t in times.items():
        dev_t = f"  device {dtimes[k]:9.4f} ms" if k in dtimes else ""
        if k in bounds:
            bd, by = bounds[k]
            dev_t += (f"  bound {bd:.4f} ms ({by}), share "
                      f"{bd / dtimes[k]:.3f}")
        log(f"    {k:20s} {t:9.4f} ms  {1e-3 * ndof / t:10.1f} MDoF/s{dev_t}")
    del f, q, u, v, st, res_op, jac_op, calls
    torch.cuda.empty_cache()

    # ---- 4b. the owner-sum kernel -------------------------------------------
    os_err, os_times = owner_sum_phase(dev, card)

    # ---- 5. reference smoke flags in hyperFS form ---------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(SMOKE_FLAGS))
    m = re.search(r"L2 Error: (\S+)", buf.getvalue())
    l2 = float(m.group(1)) if m else 0.0
    log(f"[5] cli.main({' '.join(SMOKE_FLAGS)}) -> rc {rc}, MMS rel-L2 {l2} "
        f"(JAX package, f64 CPU: rc {SMOKE_REF_RC}, {SMOKE_REF_L2})")
    if rc != SMOKE_REF_RC or abs(l2 - SMOKE_REF_L2) > 1e-3 * SMOKE_REF_L2:
        raise AssertionError("CLI smoke disagrees with the JAX package")

    # ---- 6-8. solves through ElasticityProblem -----------------------------
    def solve(dtype, box, multigrid="none", level_quadrature="native",
              by_physics=False, **kw):
        """One -test increment (hyperFS degree 4 unless kw says otherwise);
        launch counts are set to 0 just before the solve and read just
        after, by (mode, P, Q) or by (physics, mode, P, Q); the owner-sum's
        kernel launches of the solve's request, each owner-sum's."""
        prob = make_problem(box, multigrid, dev, dtype, level_quadrature,
                            **kw)
        fa.COUNTS.reset()
        info = prob.solve()
        last_owner[0] = owner_sum_counts(f"{multigrid} {box}^3 {dtype}")
        counts = dict(fa.COUNTS.by_physics if by_physics else fa.COUNTS.by_pq)
        last_paths.clear()
        last_paths.update(fa.COUNTS.by_path)
        last_shapes.clear()
        last_shapes.update(fa.COUNTS.by_shape)
        last_pq_paths.clear()
        last_pq_paths.update(fa.COUNTS.by_pq_path)
        return prob, info, counts, prob.mms_error(info.u), \
            prob.strain_energy(info.u)

    last_paths = {}         # the last solve's fused-apply launches per path
    last_owner = [0]        # ... owner-sum kernel launches (= owner-sums)
    last_shapes = {}        # ... per (physics, mode, P, Q, elements)
    last_pq_paths = {}      # ... per (physics, mode, P, Q, path)
    # the main paths' generic-tile launches per (physics, mode, P, Q,
    # elements), from the solves that run it (phases 12, 14, 15)
    generic_shapes = {}

    def add_generic(shapes):
        for key, k in shapes.items():
            if fa.is_generic(key[0], *key[2:4]):
                generic_shapes[key] = generic_shapes.get(key, 0) + k

    def report(tag, prob, info, counts, err, energy):
        log(f"{tag} {info.dofs} DoF, levels {prob.level_degrees}, setup "
            f"{prob.setup_time:.2f} s")
        log(f"    converged {info.converged} ({info.reason}), SNES "
            f"{info.snes_iters}, KSP {info.ksp_iters}, rnorm {info.rnorm:.3e}")
        log(f"    solve {info.solve_time:.3f} s (preconditioner setup "
            f"{info.pc_time:.3f} s), {info.mdofs_per_sec:.2f} MDoF/s "
            f"(1e-6 dofs KSP / time) ({card})")
        log(f"    MMS rel-L2 {err:.6e}, strain energy {energy:.10e}")
        log("    kernel launches: " + ", ".join(
            f"{' '.join(map(str, key[:-2]))} (P,Q)=({key[-2]},{key[-1]}) {k}"
            for key, k in sorted(counts.items())))
        log(f"    fused-apply launches per copy path: {last_paths}; owner-sum "
            f"kernel launches {last_owner[0]} (every owner-sum)")
        if not info.converged or not math.isfinite(err):
            raise AssertionError(f"{tag} solve did not converge")

    def check_twin(tag, box, info, err, energy, du_slack=False, **kw):
        """The float64 twin of a float32 solve: same answer to 1e-3. With
        du_slack the MMS errors may also differ by |u32 - u64| / |u*|
        (the triangle inequality's bound), for a discretization error
        (1.8e-6 in linElas p4 on 16^3) within reach of the float32 solve's
        own error."""
        prob64, info64, _, err64, en64 = solve(torch.float64, box, **kw)
        du = float(torch.linalg.norm(info.u.double() - info64.u)
                   / torch.linalg.norm(info64.u))
        log(f"    float64 twin: SNES {info64.snes_iters}, KSP "
            f"{info64.ksp_iters} (float32 {info.ksp_iters}), MMS rel-L2 "
            f"{err64:.6e}, energy {en64:.10e}, |u32-u64|/|u64| {du:.3e}")
        slack = du * (1 + err64) if du_slack else 0.0
        if not (info64.converged and du <= 1e-3
                and abs(err - err64) <= 1e-3 * err64 + slack
                and abs(energy - en64) <= 1e-3 * abs(en64)):
            raise AssertionError(f"{tag} float32 solve disagrees with its "
                                 "float64 twin")

    def fine_jv_ms(prob, info):
        """CUDA-event time of one BC-masked fine J.v operator at the
        solution."""
        _, stash = prob._nonlinear_residual(info.u, prob.bc_values(1.0),
                                            prob.F)
        return time_ms(lambda: prob._jacobian_action(info.u, stash))

    # ---- 6. slice 1's main path: Jacobi CG ----------------------------------
    prob, info, c6, err6, en6 = solve(torch.float32, SOLVE_BOX)
    report(f"[6] hyperFS p4 {SOLVE_BOX}^3 float32, Jacobi CG:", prob, info, c6,
           err6, en6)
    launches6 = {m: sum(k for (mm, _, _), k in c6.items() if mm == m)
                 for m in ("residual", "jacobian")}
    owner6 = last_owner[0]
    if min(launches6.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches6}")
    t_mv = fine_jv_ms(prob, info)
    ksp6 = info.ksp_iters
    log(f"    J.v operator {t_mv:.4f} ms vs "
        f"{info.solve_time / max(ksp6, 1) * 1e3:.4f} ms wall per KSP "
        "iteration (the rest: vector ops, Newton/line search, host syncs)")
    check_twin("[6]", SOLVE_BOX, info, err6, en6)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 7. slice 2's main path: p-multigrid CG ----------------------------
    pmg = dict(multigrid="logarithmic", level_quadrature="native")
    prob, info, c7, err7, en7 = solve(torch.float32, SOLVE_BOX, **pmg)
    report(f"[7] hyperFS p4 {SOLVE_BOX}^3 float32, p-MG CG (native levels, "
           "Chebyshev coarse):", prob, info, c7, err7, en7)
    need = [("residual", 5, 5), ("jacobian", 5, 5), ("jacobian", 3, 3),
            ("jacobian", 2, 2)]
    if min(c7.get(k, 0) for k in need) < 1:
        raise AssertionError(f"p-MG path skipped a kernel instance: {c7}")
    launches7 = {m: sum(k for (mm, _, _), k in c7.items() if mm == m)
                 for m in ("residual", "jacobian")}
    owner7 = last_owner[0]
    t_mv = fine_jv_ms(prob, info)
    per_it = (info.solve_time - info.pc_time) / max(info.ksp_iters, 1) * 1e3
    log(f"    {launches7['jacobian'] / max(info.ksp_iters, 1):.1f} J.v kernel "
        "launches per CG iteration (eigenvalue-estimate applies included); "
        f"wall per CG iteration {per_it:.4f} ms (solve minus preconditioner "
        f"setup, over KSP) vs one fine J.v operator {t_mv:.4f} ms")
    log(f"    vs phase 6 (Jacobi): KSP {info.ksp_iters} vs {ksp6}; MMS rel-L2 "
        f"{err7:.6e} vs {err6:.6e}; energy {en7:.10e} vs {en6:.10e}")
    if not info.ksp_iters < ksp6:
        raise AssertionError("p-MG took no fewer CG iterations than Jacobi")
    c7_ksp = info.ksp_iters
    if not (abs(err7 - err6) <= 1e-3 * err6 and abs(en7 - en6) <= 1e-3 * en6):
        raise AssertionError("p-MG answer disagrees with the Jacobi answer")
    check_twin("[7]", SOLVE_BOX, info, err7, en7, **pmg)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 8. p-MG with fine level quadrature -------------------------------
    prob, info, c8, err8, en8 = solve(torch.float32, FINE_LEVEL_BOX,
                                      multigrid="logarithmic",
                                      level_quadrature="fine")
    report(f"[8] hyperFS p4 {FINE_LEVEL_BOX}^3 float32, p-MG CG (fine "
           "levels):", prob, info, c8, err8, en8)
    if min(c8.get(("jacobian", P, 5), 0) for P in (2, 3, 5)) < 1:
        raise AssertionError(f"fine-level path skipped an instance: {c8}")
    del prob, info

    # ---- 9. row-gather probes ---------------------------------------------
    launches9, gerr, gtimes, glib, gbounds, gprod = gather_phase(dev, card)
    main_counts = [c6, c7, c8]          # by (mode, P, Q), hyperFS only

    def need(tag, counts, keys):
        missing = [k for k in keys if counts.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"{tag} skipped kernel instances {missing}: "
                                 f"{counts}")

    def amg_report(prob, info, twin=None):
        """AMG levels, CG exits and the refresh split. Raises when CG exited
        on p.Ap <= 0 more often than in the float64 twin (`twin`, whose
        tangent may itself be indefinite), or at all without one."""
        cg = prob.cg_exits
        log(f"    AMG levels (n, representation): "
            f"{prob._amg.level_summary()}; CG exits {cg}")
        t = prob.amg_times
        log(f"    AMG refreshes {prob.pc_setups}: element matrices "
            f"{t['elem_mats']:.4f} s, d2h {t['d2h']:.4f} s, native setup "
            f"{t['setup']:.4f} s, upload {t['upload']:.4f} s (inside "
            f"preconditioner setup {info.pc_time:.4f} s) ({card})")
        allowed = 0 if twin is None else twin.cg_exits.get("indefinite", 0)
        if cg.get("indefinite", 0) > allowed:
            raise AssertionError("CG with the AMG cycle exited on p.Ap <= 0 "
                                 f"{cg['indefinite']} times (float64 twin: "
                                 f"{allowed})")

    # ---- 10. the reference's smoke test, its flags exactly ------------------
    fa.COUNTS.reset()
    rc, out, prob, info = run_cli(REFERENCE_SMOKE)
    c10 = dict(fa.COUNTS.by_physics)
    l2 = prob.mms_error(info.u)
    log(f"[10] cli.main({' '.join(REFERENCE_SMOKE)}) -> rc {rc}, output "
        f"{out!r}; {prob.config.problem}, levels {prob.level_degrees}, "
        f"{str(prob.dtype)}, SNES {info.snes_iters}, KSP {info.ksp_iters} "
        f"(JAX package, f64 CPU: {REFERENCE_KSP}), MMS rel-L2 {l2:.6e} (JAX "
        f"{REFERENCE_L2}; |diff| {abs(l2 - REFERENCE_L2) / REFERENCE_L2:.2e} "
        f"relative, tolerance {REFERENCE_L2_RTOL})")
    amg_report(prob, info)
    log("    kernel launches: " + ", ".join(
        f"{ph} {m} ({P},{Q}) {k}" for (ph, m, P, Q), k in sorted(c10.items()))
        + f"; per copy path {dict(fa.COUNTS.by_path)}")
    if (rc != 0 or out
            or abs(l2 - REFERENCE_L2) > REFERENCE_L2_RTOL * REFERENCE_L2):
        raise AssertionError("the reference smoke test failed on the port")
    need("[10]", c10, [("linElas", "residual", 4, 4),
                       ("linElas", "jacobian", 4, 4),
                       ("linElas", "jacobian", 3, 3),
                       ("linElas", "jacobian", 2, 2)])
    del prob, info

    # ---- 11. slice 4's main path: p-MG with the AMG coarse solve ------------
    amg = dict(multigrid="logarithmic", level_quadrature="native",
               coarse_solve="amg", by_physics=True)
    prob, info, c11, err11, en11 = solve(torch.float32, SOLVE_BOX, **amg)
    report(f"[11] hyperFS p4 {SOLVE_BOX}^3 float32, p-MG CG (native levels, "
           "AMG coarse):", prob, info, c11, err11, en11)
    amg_report(prob, info)
    need("[11]", c11, [("hyperFS", "residual", 5, 5),
                       ("hyperFS", "jacobian", 5, 5),
                       ("hyperFS", "jacobian", 3, 3),
                       ("hyperFS", "jacobian", 2, 2)])
    jv11 = sum(k for (_, m, _, _), k in c11.items() if m == "jacobian")
    per_it = (info.solve_time - info.pc_time) / max(info.ksp_iters, 1) * 1e3
    log(f"    {jv11 / max(info.ksp_iters, 1):.1f} J.v kernel launches per CG "
        f"iteration (eigenvalue-estimate applies included); wall per CG "
        f"iteration {per_it:.4f} ms")
    log(f"    vs phase 7 (Chebyshev coarse): KSP {info.ksp_iters} vs "
        f"{c7_ksp}; MMS rel-L2 {err11:.6e} vs {err7:.6e}; energy "
        f"{en11:.10e} vs {en7:.10e}")
    if not (abs(err11 - err7) <= 1e-3 * err7
            and abs(en11 - en7) <= 1e-3 * en7):
        raise AssertionError("p-MG + AMG answer disagrees with phase 7's")
    ksp11 = info.ksp_iters
    check_twin("[11]", SOLVE_BOX, info, err11, en11, f32_tolerances=True,
               du_slack=True, **amg)
    main_counts.append(c11)
    prob11, info11 = prob, info         # phase 17 post-processes this solve
    info11_snes, info11_ksp = info.snes_iters, info.ksp_iters   # phase 18
    solve11_s = info.solve_time
    del prob, info
    torch.cuda.empty_cache()

    # ---- 12. linElas degree 4; the hyperSS and hyperFSIncomp clamp solves ---
    lin = dict(amg, problem="linElas")
    prob, info, c12, err12, en12 = solve(torch.float32, SOLVE_BOX, **lin)
    report(f"[12] linElas p4 {SOLVE_BOX}^3 float32, p-MG CG + AMG:", prob,
           info, c12, err12, en12)
    amg_report(prob, info)
    need("[12]", c12, [("linElas", "residual", 5, 5),
                       ("linElas", "jacobian", 5, 5),
                       ("linElas", "jacobian", 3, 3),
                       ("linElas", "jacobian", 2, 2)])
    check_twin("[12]", SOLVE_BOX, info, err12, en12, f32_tolerances=True,
               du_slack=True, **lin)
    main_counts.append(c12)
    del prob, info
    torch.cuda.empty_cache()
    def clamp_pair(tag, name, kw, keys, counts=True, newton=()):
        """A clamp solve on the CLAMP_BOX^3 box, float32 against its
        float64 twin: converged, energy to 1e-5, u to 1e-3, CG's indefinite
        exits no more than the twin's and, with `counts`, the same SNES
        count and KSP within 10%; the float32 solve's launches, counted
        from 0, must cover `keys`. `newton`: NewtonOptions fields set in
        both solves."""
        runs = {}
        for dtype in (torch.float32, torch.float64):
            cfg = Config(**kw, box_faces=(CLAMP_BOX,) * 3, device=dev,
                         dtype=dtype, ksp_rtol=1e-6)
            cfg.newton.rtol = 1e-6      # the CLI's float32 policy, both
            for k_, v_ in newton:
                setattr(cfg.newton, k_, v_)
            p = ElasticityProblem(cfg)
            fa.COUNTS.reset()
            i = p.solve()
            runs[dtype] = (p, i, dict(fa.COUNTS.by_physics),
                           p.strain_energy(i.u), dict(fa.COUNTS.by_path),
                           dict(fa.COUNTS.by_shape))
        ((p32, i32, c32, w32, paths32, shapes32),
         (p64, i64, _, w64, _, _)) = runs.values()
        add_generic(shapes32)
        du = float(torch.linalg.norm(i32.u.double() - i64.u)
                   / torch.linalg.norm(i64.u))
        log(f"{tag} {name} clamp, degree {kw['degree']}"
            f"{', qextra ' + str(kw['qextra']) if kw.get('qextra') else ''} "
            f"on {CLAMP_BOX}^3 ({i32.dofs} DoF), p-MG {p32.level_degrees} + "
            f"AMG, float32 / float64: converged {i32.converged} / "
            f"{i64.converged}, SNES {i32.snes_iters} / {i64.snes_iters}, KSP "
            f"{i32.ksp_iters} / {i64.ksp_iters}, energy {w32:.10e} / "
            f"{w64:.10e}, |u32-u64|/|u64| {du:.3e}, solve "
            f"{i32.solve_time:.3f} / {i64.solve_time:.3f} s ({card})")
        log(f"    float64 twin CG exits {p64.cg_exits}")
        amg_report(p32, i32, twin=p64)
        log("    kernel launches: " + ", ".join(
            f"{ph} {m} ({P},{Q}) {k}" for (ph, m, P, Q), k in
            sorted(c32.items())) + f"; per path {paths32}")
        same_counts = (i32.snes_iters == i64.snes_iters and abs(
            i32.ksp_iters - i64.ksp_iters) <= 0.1 * i64.ksp_iters)
        if not (i32.converged and i64.converged
                and (same_counts or not counts) and du <= 1e-3
                and abs(w32 - w64) <= 1e-5 * abs(w64)):
            raise AssertionError(f"{tag} {name} float32 clamp solve "
                                 "disagrees with its float64 twin")
        need(f"{tag} {name}", c32, keys)
        return c32

    for name, kw in CLAMP.items():
        keys = [(name, "residual", 3, 3), (name, "jacobian", 3, 3),
                (name, "jacobian", 2, 2)]
        if name == "hyperFSIncomp":
            keys += [(PRESSURE, "residual", 3, 1),
                     (PRESSURE, "jacobian", 3, 1),
                     (PRESSURE, "jacobian", 2, 1)]
        main_counts.append(clamp_pair("[12]", name, kw, keys))
    torch.cuda.empty_cache()

    # ---- 13. PCGAMG: degree 1, CG preconditioned by the AMG alone -----------
    pcgamg = dict(multigrid="logarithmic", coarse_solve="amg",
                  problem="linElas", degree=1, by_physics=True)
    prob, info, c13, err13, en13 = solve(torch.float32, PCGAMG_BOX, **pcgamg)
    report(f"[13] linElas p1 {PCGAMG_BOX}^3 float32, PCGAMG (CG + AMG "
           "V-cycle):", prob, info, c13, err13, en13)
    amg_report(prob, info)
    if prob._use_mg or not prob._use_amg:
        raise AssertionError("[13] did not run PCGAMG")
    need("[13]", c13, [("linElas", "residual", 2, 2),
                       ("linElas", "jacobian", 2, 2)])
    check_twin("[13]", PCGAMG_BOX, info, err13, en13, f32_tolerances=True,
               du_slack=True, **pcgamg)
    main_counts.append(c13)
    main_counts.append(c10)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 14. hyperFSIncomp -qextra 1: the pressure term on the generic tile -
    c14 = clamp_pair("[14]", "hyperFSIncomp", INCOMP_QEXTRA, [
        ("hyperFSIncomp", "residual", 5, 6),
        ("hyperFSIncomp", "jacobian", 5, 6),
        (PRESSURE, "residual", 5, 2), (PRESSURE, "jacobian", 5, 2),
        (PRESSURE, "jacobian", 3, 2), (PRESSURE, "jacobian", 2, 2)],
        counts=False)
    main_counts.append(c14)
    torch.cuda.empty_cache()

    # ---- 15. hyperFS degree 6: the fine level on the generic tile ----------
    deg6 = dict(multigrid="logarithmic", level_quadrature="native",
                coarse_solve="amg", degree=6, by_physics=True)
    prob, info, c15, err15, en15 = solve(torch.float32, DEGREE6_BOX, **deg6)
    add_generic(last_shapes)
    report(f"[15] hyperFS p6 {DEGREE6_BOX}^3 float32, p-MG CG + AMG:", prob,
           info, c15, err15, en15)
    amg_report(prob, info)
    need("[15]", c15, [("hyperFS", "residual", 7, 7),
                       ("hyperFS", "jacobian", 7, 7),
                       ("hyperFS", "jacobian", 5, 5)])
    check_twin("[15]", DEGREE6_BOX, info, err15, en15, f32_tolerances=True,
               du_slack=True, **deg6)
    main_counts.append(c15)
    del prob, info
    torch.cuda.empty_cache()

    # ---- 16. an Exodus-II file through cli.main -mesh, at phase 11's size ---
    k = EXODUS_BOX
    scr = scrambled_box_mesh((k, k, k), k)
    exo = Path(__file__).resolve().parent / "build" / "chip_smoke"
    exo.mkdir(parents=True, exist_ok=True)
    exo = exo / f"scrambled{k}_hex27.exo"
    write_exodus_hex27(exo, scr, {998: faces_on(scr, 0, 0.0),
                                  999: faces_on(scr, 0, 1.0)})
    fa.COUNTS.reset()
    rc_e, out_e, prob_e, info_e = run_cli(
        EXODUS_FLAGS + ["-mesh", str(exo), "-bc_clamp", "998,999",
                        "-bc_clamp_999_translate", EXODUS_SHIFT])
    c16 = dict(fa.COUNTS.by_physics)
    paths16 = dict(fa.COUNTS.by_path)
    rc_b, out_b, prob_b, info_b = run_cli(
        EXODUS_FLAGS + ["-dm_plex_box_faces", f"{k},{k},{k}", "-bc_clamp",
                        "6,5", "-bc_clamp_5_translate", EXODUS_SHIFT])
    w_e, w_b = prob_e.strain_energy(info_e.u), prob_b.strain_energy(info_b.u)
    xe, ue = by_coordinates(prob_e, info_e.u)
    xb, ub = by_coordinates(prob_b, info_b.u)
    du = float(np.linalg.norm(ue - ub) / np.linalg.norm(ub))
    log(f"[16] cli.main -mesh {exo.name} ({prob_e.mesh.num_elements} "
        f"elements, {info_e.dofs} DoF, HEX27 read as corners, reordered) vs "
        f"the lattice {k}^3 box: rc {rc_e} / {rc_b}, {prob_e.dtype}, levels "
        f"{prob_e.level_degrees} / {prob_b.level_degrees}")
    log(f"    SNES {info_e.snes_iters} / {info_b.snes_iters}, KSP "
        f"{info_e.ksp_iters} / {info_b.ksp_iters}, energy {w_e:.10e} / "
        f"{w_b:.10e}, |u_exo - u_box| / |u_box| at nodes matched by "
        f"coordinates {du:.3e}, setup {prob_e.setup_time:.2f} / "
        f"{prob_b.setup_time:.2f} s (mesh read and reordered, FE spaces, "
        f"operators), solve {info_e.solve_time:.3f} / "
        f"{info_b.solve_time:.3f} s ({card})")
    amg_report(prob_e, info_e)
    log("    kernel launches (-mesh run): " + ", ".join(
        f"{ph} {m} ({P},{Q}) {n_}" for (ph, m, P, Q), n_ in
        sorted(c16.items())) + f"; per path {paths16}")
    if not (rc_e == rc_b == 0 and info_e.converged and info_b.converged
            and prob_e.mesh.num_elements == k ** 3
            and info_e.dofs == info_b.dofs
            and np.abs(xe - xb).max() <= 1e-12
            and info_e.snes_iters == info_b.snes_iters
            and abs(w_e - w_b) <= 1e-3 * abs(w_b) and du <= 1e-3):
        raise AssertionError("[16] the Exodus solve disagrees with the box's")
    need("[16]", c16, [("hyperFS", "residual", 5, 5),
                       ("hyperFS", "jacobian", 5, 5),
                       ("hyperFS", "jacobian", 3, 3),
                       ("hyperFS", "jacobian", 2, 2)])
    main_counts.append(c16)
    del prob_e, prob_b, info_e, info_b
    torch.cuda.empty_cache()

    # ---- 17. post-processing, resume, ls_max_it, the CLI's VTU views -------
    t17 = time.perf_counter()
    post_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    post_dir.mkdir(parents=True, exist_ok=True)
    # (a) the diagnostics of phase 11's solution, and its VTU file
    u11 = info11.u
    t0 = time.perf_counter()
    diag = prob11.diagnostics(u11)              # builds the operator first
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    diag_ms = device_ms(lambda: prob11.diagnostics(u11), reps=5, inner=3)
    diag_call_ms = time_ms(lambda: prob11.diagnostics(u11), reps=5)
    ref = make_problem(SOLVE_BOX, "none", dev, torch.float64).diagnostics(
        u11.double())
    col_err = ((diag - ref).abs().amax(dim=0)
               / ref.abs().amax(dim=0)).tolist()
    same_u = torch.equal(diag[:, :3], u11.double().T)
    log(f"[17] diagnostics of phase 11's solution ({info11.dofs} DoF, "
        f"{diag.shape[0]} nodes, {diag.dtype} on {diag.device}): device "
        f"{diag_ms:.4f} ms, call {diag_call_ms:.4f} ms, first call with its "
        f"setup {first_s:.3f} s; phase 11's solve {solve11_s:.3f} s ({card})")
    log("    vs a float64 multigrid=none problem's on u.double(): max |diff| "
        "/ max |ref| per column " + ", ".join(f"{e:.1e}" for e in col_err)
        + f"; columns 0-2 equal u: {same_u}")
    if not (diag.dtype == torch.float64
            and diag.shape == (prob11.fine_space.num_nodes, 8)
            and max(col_err) <= 1e-12 and same_u):
        raise AssertionError("[17] the diagnostics disagree with the float64 "
                             "problem's")
    vtu = post_dir / "solution-final.vtu"
    t0 = time.perf_counter()
    write_vtu(str(vtu), prob11.fine_space, u11.cpu().numpy(),
              diag.cpu().numpy())
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npts, ncells, arrays = read_vtu(vtu)
    parse_s = time.perf_counter() - t0
    u_host = u11.double().cpu().numpy().T
    # .9g keeps 9 significant digits: within half a unit of the ninth
    disp_ok = bool(np.all(np.abs(arrays["displacement"].reshape(-1, 3)
                                 - u_host) <= 5.0001e-9 * np.abs(u_host)))
    n1 = 4 * SOLVE_BOX
    log(f"    {vtu.name}: write {write_s:.2f} s (the host copy included), "
        f"{vtu.stat().st_size / 1e6:.1f} MB; parsed back in {parse_s:.2f} "
        f"s: {npts} points, {ncells} cells, displacement equal to 9 "
        f"significant digits: {disp_ok}")
    if not (npts == (n1 + 1) ** 3 and ncells == n1 ** 3 and disp_ok):
        raise AssertionError(f"[17] {vtu.name} does not hold the solution")
    del prob11, info11, u11, diag, ref, arrays
    torch.cuda.empty_cache()

    # (b) a clamp solve cut at load 0.5 and resumed in a fresh problem
    def resume_problem(**kw):
        cfg = Config(**RESUME, box_faces=(CLAMP_BOX,) * 3, device=dev,
                     dtype=torch.float32, ksp_rtol=1e-6, **kw)
        cfg.newton.rtol = RESUME_RTOL
        return ElasticityProblem(cfg)

    ckpt = {"floor": 0.0}

    def checkpoint(inc, load, res):
        if res.converged:
            ckpt.update(u=res.u, load=load,
                        floor=max(ckpt["floor"], res.rnorm))

    fa.COUNTS.reset()
    p_full = resume_problem()
    i_full = p_full.solve()
    p_cut = resume_problem(stop_at_load=0.5)
    i_cut = p_cut.solve(checkpoint)
    p_res = resume_problem()
    i_res = p_res.solve(u0=ckpt["u"], start_load=ckpt["load"],
                        floor_atol0=ckpt["floor"])
    c17 = dict(fa.COUNTS.by_physics)
    w_full, w_res = p_full.strain_energy(i_full.u), p_res.strain_energy(
        i_res.u)
    du = float(torch.linalg.norm(i_res.u - i_full.u)
               / torch.linalg.norm(i_full.u))
    log(f"    resume: hyperFS p4 {CLAMP_BOX}^3 clamp ({i_full.dofs} DoF, face "
        f"5 translated by {RESUME['bc_clamp_translate'][5]}), 4 increments, "
        f"p-MG {p_full.level_degrees} + AMG, float32: unbroken SNES "
        f"{i_full.snes_iters}, KSP {i_full.ksp_iters}; cut at load "
        f"{ckpt['load']} SNES {i_cut.snes_iters}, KSP {i_cut.ksp_iters}, "
        f"resumed SNES {i_res.snes_iters}, KSP {i_res.ksp_iters}; energy "
        f"{w_res:.10e} / {w_full:.10e}, |u_res - u|/|u| {du:.3e}; solves "
        f"{i_full.solve_time:.3f} / {i_cut.solve_time:.3f} + "
        f"{i_res.solve_time:.3f} s; Newton rtol {RESUME_RTOL} ({card})")
    for p_, i_ in ((p_full, i_full), (p_cut, i_cut), (p_res, i_res)):
        amg_report(p_, i_)
    if not (ckpt["load"] == 0.5 and i_full.converged and i_cut.converged
            and i_res.converged
            and i_cut.snes_iters + i_res.snes_iters == i_full.snes_iters
            and abs(i_cut.ksp_iters + i_res.ksp_iters - i_full.ksp_iters)
            <= 0.1 * i_full.ksp_iters
            and du <= 1e-4 and abs(w_res - w_full) <= 1e-5 * abs(w_full)):
        raise AssertionError("[17] the resumed solve disagrees with the "
                             "unbroken one")
    hyper_keys = [("hyperFS", "residual", 5, 5), ("hyperFS", "jacobian", 5, 5),
                  ("hyperFS", "jacobian", 3, 3), ("hyperFS", "jacobian", 2, 2)]
    need("[17]", c17, hyper_keys)
    main_counts.append(c17)
    del p_full, p_cut, p_res, i_full, i_cut, i_res, ckpt
    torch.cuda.empty_cache()

    # (c) the same clamp with two secant steps a line search, step by step
    searches = [0]
    secant = newton_mod.secant_search

    def counted(*a, **kw):
        searches[0] += 1
        return secant(*a, **kw)

    newton_mod.secant_search = counted
    c17c = clamp_pair("[17]", "hyperFS", RESUME, hyper_keys,
                      newton=[("rtol", RESUME_RTOL), ("ls_max_it", 2)])
    newton_mod.secant_search = secant
    log(f"    ls_max_it 2: {searches[0]} secant searches in the two solves")
    if not searches[0]:
        raise AssertionError("[17] ls_max_it 2 ran no secant search")
    main_counts.append(c17c)

    # (d) the reference smoke flags with -view_soln -view_final_soln
    cli_dir = post_dir / "cli"
    cli_dir.mkdir(exist_ok=True)
    for f in cli_dir.glob("*.vtu"):
        f.unlink()
    cwd = Path.cwd()
    os.chdir(cli_dir)
    fa.COUNTS.reset()
    try:
        rc, out, prob, info = run_cli(REFERENCE_SMOKE
                                      + ["-view_soln", "-view_final_soln"])
    finally:
        os.chdir(cwd)
    c17d = dict(fa.COUNTS.by_physics)
    files = sorted(f.name for f in cli_dir.glob("*.vtu"))
    want = [f"solution-{i:03d}.vtu"
            for i in range(1, prob.config.num_increments + 1)]
    want.append("solution-final.vtu")
    parsed = {f: read_vtu(cli_dir / f) for f in files}
    log(f"    cli.main({' '.join(REFERENCE_SMOKE)} -view_soln "
        f"-view_final_soln) -> rc {rc}, output {out!r}, files "
        + ", ".join(f"{f} ({n} points, {len(a)} arrays)"
                    for f, (n, _, a) in parsed.items()))
    if not (rc == 0 and not out and files == want
            and all(n == prob.fine_space.num_nodes
                    and a["displacement"].size == 3 * n
                    for n, _, a in parsed.values())
            and "strain_energy_density" in parsed["solution-final.vtu"][2]):
        raise AssertionError("[17] the CLI's VTU files are wrong")
    need("[17]", c17d, [("linElas", "residual", 4, 4),
                        ("linElas", "jacobian", 4, 4)])
    main_counts.append(c17d)
    del prob, info, parsed
    log(f"    phase 17 {time.perf_counter() - t17:.1f} s")

    # ---- 18. the distributed driver -----------------------------------------
    c18 = dist_phase(dev, card, exo, (info11_snes, info11_ksp))
    need("[18]", c18, [("hyperFS", "residual", 5, 5),
                       ("hyperFS", "jacobian", 5, 5),
                       ("hyperFS", "jacobian", 3, 5),
                       ("hyperFS", "jacobian", 2, 5)])
    main_counts.append(c18)
    launches18 = {m: sum(k for (ph, mm, _, _), k in c18.items()
                         if ph == "hyperFS" and mm == m)
                  for m in ("residual", "jacobian")}

    # ---- 20. the rank-count sweeps ------------------------------------------
    sweep_phase(card)

    # ---- 19. the high degrees: the generic tile's cluster body in solves ---
    from ceedpetscsolid_tpu_torch.utils.profile_solve import (
        FUSED, device_events)
    t19 = time.perf_counter()
    high = dict(multigrid="logarithmic", level_quadrature="native",
                coarse_solve="amg", by_physics=True)
    for deg, box, dname in HIGH_DEGREE:
        dtype, P = getattr(torch, dname), deg + 1
        tag = f"[19] hyperFS p{deg} {box}^3 {dname}"
        if dtype == torch.float32:
            # through cli.main, its launches counted from 0
            fa.COUNTS.reset()
            rc, _, prob, info = run_cli(HIGH_DEGREE_FLAGS)
            c19 = dict(fa.COUNTS.by_physics)
            last_paths.clear()
            last_paths.update(fa.COUNTS.by_path)
            last_shapes.clear()
            last_shapes.update(fa.COUNTS.by_shape)
            last_pq_paths.clear()
            last_pq_paths.update(fa.COUNTS.by_pq_path)
            err, energy = prob.mms_error(info.u), prob.strain_energy(info.u)
            tag += f", cli.main {' '.join(HIGH_DEGREE_FLAGS)} -> rc {rc}"
            # elasticity.c:806-811: -test returns 1 above 5% MMS error
            if rc != (1 if err > 0.05 else 0):
                raise AssertionError(f"{tag}: rc {rc} at MMS error {err}")
        else:
            prob, info, c19, err, energy = solve(dtype, box, degree=deg,
                                                 **high)
        add_generic(last_shapes)
        paths19 = dict(last_paths)
        report(f"{tag}, p-MG CG + AMG:", prob, info, c19, err, energy)
        amg_report(prob, info)
        need(tag, c19, [("hyperFS", "residual", P, P),
                        ("hyperFS", "jacobian", P, P),
                        ("hyperFS", "jacobian", 9, 9)])
        # the fine level's residual and J.v and the (9, 9) level's J.v ran
        # the body their plans name
        bodies = {(m_, p_): fa.generic_plan(p_, p_, dtype, box ** 3).path
                  for m_, p_ in (("residual", P), ("jacobian", P),
                                 ("jacobian", 9))}
        ran = {k_: last_pq_paths.get(("hyperFS", k_[0], k_[1], k_[1], b_), 0)
               for k_, b_ in bodies.items()}
        log(f"    bodies the plans name: {bodies}; their launches: {ran}")
        if min(ran.values()) < 1:
            raise AssertionError(f"{tag} did not launch the bodies its plans "
                                 f"name: {bodies}, {last_pq_paths}")
        if dtype == torch.float32:
            check_twin(tag, box, info, err, energy, f32_tolerances=True,
                       du_slack=True, degree=deg, **high)
            # Jacobi CG on the same problem, held to the p-MG answer as
            # phase 7 holds p-MG to phase 6's Jacobi; then one more solve
            # under torch.profiler for its fused J.v device time
            pj, ij, cj, ej, enj = solve(dtype, box, degree=deg,
                                        f32_tolerances=True, by_physics=True)
            add_generic(last_shapes)
            report(f"[19] hyperFS p{deg} {box}^3 {dname}, Jacobi CG:", pj, ij,
                   cj, ej, enj)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                pj.solve()
                torch.cuda.synchronize()
            jv_ms = sum(t_ for n_, t_ in device_events(prof)
                        if (hit := FUSED.search(n_)) and hit.group(1) == "true"
                        ) * 1e-3
            log(f"    Jacobi: solve {ij.solve_time:.3f} s wall, fused J.v "
                f"{jv_ms:.1f} ms device (a second solve, profiled) "
                f"({card}); vs p-MG: KSP {ij.ksp_iters} vs "
                f"{info.ksp_iters}, MMS rel-L2 {ej:.6e} vs {err:.6e}, energy "
                f"{enj:.10e} vs {energy:.10e}")
            if not (abs(ej - err) <= 1e-3 * err
                    and abs(enj - energy) <= 1e-3 * abs(energy)):
                raise AssertionError(f"{tag}: Jacobi answer disagrees with "
                                     "the p-MG answer")
            main_counts.append(cj)
            del pj, ij
        main_counts.append(c19)
        del prob, info
        torch.cuda.empty_cache()
    log(f"    phase 19 {time.perf_counter() - t19:.1f} s ({card})")

    def instances(physics, mode, generic=False):
        """'P,Q' -> launches of one physics and mode over the main paths,
        of the template instances or of the generic tile."""
        out = {}
        for c in main_counts:
            for key, k in c.items():
                ph, m, P, Q = key if len(key) == 4 else ("hyperFS", *key)
                if ((ph, m) == (physics, mode)
                        and fa.is_generic(ph, P, Q) == generic):
                    out[f"{P},{Q}"] = out.get(f"{P},{Q}", 0) + k
        return out

    def bound(b, device_ms):
        """The bound keys of a kernel entry: (ms, what bounds it) from this
        run's shapes, and the device time's share of it."""
        return {"bound_ms": b[0], "bound_by": b[1],
                "bound_share": b[0] / device_ms}

    def generic_rows():
        """The generic tile's entries: one per (physics, mode, P, Q,
        elements) where the main paths launch it, with the launches counted
        there; the same kernel timed on a larger mesh (24^3, 12^3), which
        no main path launches, goes under "larger_mesh" of the entries of
        its (physics, mode, P, Q)."""
        rows, larger = {}, {}
        for (ph, P, Q, box), (t, d, bd, pl, e, dn, bk) in gtimes3d.items():
            for i, mode in enumerate(("residual", "jacobian")):
                if mode not in t:
                    continue
                entry = {
                    "box": box, "dtype": dn, "max_abs_err": e[i],
                    "ms": t[mode],
                    "plain_ms": t[mode + "_plain"], "device_ms": d[mode],
                    "plain_device_ms": d[mode + "_plain"],
                    **bound(bd[mode], d[mode]),
                    "plan": {"body": pl[mode].body, "copy": pl[mode].copy,
                             "elems": pl[mode].elems,
                             "tiles": pl[mode].tiles,
                             "threads": pl[mode].threads,
                             "smem": pl[mode].smem,
                             "workspace": pl[mode].work,
                             "cluster": pl[mode].cluster,
                             "clusters": pl[mode].clusters},
                    **({"by_cluster_size": {k: x[mode] for k, x in
                                            bk.items()}} if bk else {})}
                key = (ph, mode, P, Q, box ** 3)
                n_ = generic_shapes.get(key, 0)
                if n_:
                    rows[key] = (n_, entry)
                else:
                    larger[key[:4]] = entry
        unrowed = set(generic_shapes) - set(rows)
        beside_none = set(larger) - {k[:4] for k in rows}
        if unrowed or beside_none:
            raise AssertionError(
                "phase 3d timed no shape of a main-path generic launch "
                f"{sorted(unrowed)}, or a shape beside none "
                f"{sorted(beside_none)}")
        return [
            {"name": f"fused_apply_generic_{mode}[{ph} ({P},{Q}) "
                     f"{e['box']}^3 {e['dtype']} {e['plan']['body']}]",
             "route": "cuda", "source": CU_SOURCE, "replaces": TPU_KERNEL,
             "launches": n_, **e, "library_ms": None, "physics": ph,
             "instances": instances(ph, mode, generic=True),
             **({"larger_mesh": larger[key[:4]]} if key[:4] in larger
                else {})}
            for key, (n_, e) in rows.items()
            for ph, mode, P, Q, _ in (key,)]

    # ms / plain_ms: one call, the host's enqueue included; device_ms:
    # the device's work alone; library_ms: one PyTorch call of the same
    # function (none computes the fused apply's)
    kernels = [
        {"name": f"fused_apply_{mode}", "route": "cuda", "source": CU_SOURCE,
         "replaces": TPU_KERNEL,
         "launches": launches7[mode] + launches18[mode],
         "max_abs_err": e, "ms": times[mode], "plain_ms": times[mode + "_plain"],
         "device_ms": dtimes[mode], "plain_device_ms": dtimes[mode + "_plain"],
         **bound(bounds[mode], dtimes[mode]), "library_ms": None,
         "physics": "hyperFS", "instances": instances("hyperFS", mode)}
        for mode, e in (("residual", max(errs[0::2])),
                        ("jacobian", max(errs[1::2])))
    ] + [
        {"name": f"fused_apply_{mode}[{ph}]", "route": "cuda",
         "source": CU_SOURCE, "replaces": TPU_KERNEL,
         "launches": sum(instances(ph, mode).values()),
         "max_abs_err": max(perr[ph][i::2]), "ms": ptimes[ph][0][mode],
         "plain_ms": ptimes[ph][0][mode + "_plain"],
         "device_ms": ptimes[ph][1][mode],
         "plain_device_ms": ptimes[ph][1][mode + "_plain"],
         **bound(ptimes[ph][2][mode], ptimes[ph][1][mode]),
         "library_ms": None, "physics": ph, "instances": instances(ph, mode)}
        for ph in (*NEW_PHYSICS, PRESSURE)
        for i, mode in enumerate(("residual", "jacobian"))
    ] + generic_rows() + [
        {"name": f"owner_sum[{ncomp} comp {dn}]", "route": "cuda",
         "source": OWNER_SUM_SOURCE, "replaces": None,
         "launches": owner6 + owner7, "max_abs_err": os_err,
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "device_ms": t["device_ms"], "plain_device_ms": t["plain_device_ms"],
         **bound((t["bound_ms"], "bytes"), t["device_ms"]),
         "library_ms": t["library_ms"],
         "library_device_ms": t["library_device_ms"]}
        for (ncomp, dn), t in os_times.items()
    ] + [
        {"name": f"gather_{name}", "route": "cuda", "source": PROBE_SOURCE,
         "replaces": PROBE_TPU[name], "launches": launches9[name],
         "max_abs_err": gerr[name], **gtimes[name],
         **bound((gbounds[name], "bytes"), gtimes[name]["device_ms"]),
         "library_ms": glib["index"]["ms"],
         "library_device_ms": glib["index"]["device_ms"],
         **({"matmul_ms": glib["matmul"]["ms"],
             "matmul_device_ms": glib["matmul"]["device_ms"]}
            if name == "onehot" else {}),
         **({"production": gprod} if name == "loop" else {})}
        for name in PROBE_TPU
    ]
    if min(k["launches"] for k in kernels) < 1:
        raise AssertionError("a kernel was launched no time on the main "
                             f"paths: {[k['name'] for k in kernels]}")
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase18_alone(parts):
    """Phase 18's parts (any of "abcd") after the build alone, e.g. (d) on
    a four-card machine; phase 11's counts are not printed, and (c) writes
    phase 16's HEX27 file first."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ceedpetscsolid_tpu_torch import native
    from ceedpetscsolid_tpu_torch.csrc.build import build
    from ceedpetscsolid_tpu_torch.mesh.scrambled import (
        faces_on, scrambled_box_mesh, write_exodus_hex27)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        amg_build = pool.submit(native.build)
        build()
    amg_build.result()
    card = card_line()
    log(f"[2] build {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.device_count()} card(s): {card}")
    exo = None
    if "c" in parts:
        k = EXODUS_BOX
        scr = scrambled_box_mesh((k, k, k), k)
        exo = Path(__file__).resolve().parent / "build" / "chip_smoke"
        exo.mkdir(parents=True, exist_ok=True)
        exo = exo / f"scrambled{k}_hex27.exo"
        write_exodus_hex27(exo, scr, {998: faces_on(scr, 0, 0.0),
                                      999: faces_on(scr, 0, 1.0)})
    dist_phase(torch.device("cuda"), card, exo, ("-", "-"), parts)
    return 0


def phase4b_alone():
    """Phase 4b after the build alone, then phases 6 and 7's float32 solves
    (Jacobi CG; p-MG with the Chebyshev coarse solve) with their owner-sum
    counters, without the twins and the rest of their checks."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ceedpetscsolid_tpu_torch.csrc.build import build
    from ceedpetscsolid_tpu_torch.utils.profile_solve import make_problem

    t0 = time.perf_counter()
    build()
    card = card_line()
    dev = torch.device("cuda")
    log(f"[2] build {time.perf_counter() - t0:.1f} s ({card})")
    owner_sum_phase(dev, card)
    for tag, mg in (("6", "none"), ("7", "logarithmic")):
        prob = make_problem(SOLVE_BOX, mg, dev, torch.float32)
        info = prob.solve()
        k = owner_sum_counts(f"[{tag}]")
        log(f"[{tag}] hyperFS p4 {SOLVE_BOX}^3 float32, multigrid {mg}: "
            f"converged {info.converged}, KSP {info.ksp_iters}, owner-sum "
            f"kernel launches {k} (every owner-sum)")
        if not info.converged:
            raise AssertionError(f"[{tag}] solve did not converge")
    return 0


def phase20_alone():
    """The whole rank-count sweep after the build alone, e.g. on a
    four-card machine."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ceedpetscsolid_tpu_torch import native
    from ceedpetscsolid_tpu_torch.csrc.build import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        amg_build = pool.submit(native.build)
        build()
    amg_build.result()
    card = card_line()
    log(f"[2] build {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.device_count()} card(s): {card}")
    sweep_phase(card, full=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase18"] and len(sys.argv) == 3:
        sys.exit(phase18_alone(sys.argv[2]))
    if sys.argv[1:] == ["--phase4b"]:
        sys.exit(phase4b_alone())
    if sys.argv[1:] == ["--phase20"]:
        sys.exit(phase20_alone())
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--phase4b | --phase18 PARTS | "
                 "--phase20]")
    sys.exit(main())
