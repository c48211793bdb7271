"""gather_loop (K5) and gather_onehot (K6) against another commit's, on the
same card.

    python -m ceedpetscsolid_tpu_torch.utils.compare_probes --parent DIR
        [--json FILE] [--sweep]

DIR is a checkout of another commit (`git archive <commit> | tar -x -C
DIR`). Its csrc/gather_probe.cu is built alone by this checkout's
csrc/build.py into build/compare_probes/, its C++ namespace renamed (two
builds whose kernels share their names fail at their first launch in one
process); this checkout's kernels run through its own wrappers. A parent
whose entry point has no `per_thread` argument (K5 and K6 without a launch
plan) is called with that older signature. On the same inputs it:
  * holds the two kernels' outputs against each other and against the
    plain versions (gather_probe.probe_equal);
  * times the device's work (utils.timing.cuda_device_ms) and one call,
    the host's enqueue included (cuda_time_ms), in turns: parent, this,
    this, parent; a time is the mean of its two turns;
  * prints both device times beside the bound (gather_probe.bound_ms) and
    each one's share of it, and, in the same process, the library calls:
    bare tab[idx] and the one-hot matrix product at the probe's shape,
    index_select at the production shape.
Shapes: the probe's (512 x 128 table, 256 in-range indices) for K5 and K6,
the production shape (44,928 x 26 indices into 200,000 x 32) for K5.
--sweep also times this checkout's K6 at the probe's shape under every
launch plan of SWEEP (cluster size, slab vectors; gather_probe.onehot_plan
makes the rest), each held against the plain version on the probe's
inputs and on the non-finite ones, and its K5 at the production shape at
every U of LOOP_SWEEP (pieces a thread), held against index_select.
Needs a CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..csrc.build import BUILD_DIR, build
from ..ops import gather_probe as gp
from .compare_fused import card_line
from .timing import cuda_device_ms, cuda_time_ms

UNITS = (("gather_probe.cu", ()),)
SWEEP = tuple((cs, nv) for cs in (1, 2, 4, 8) for nv in (4, 8, 16, 32))
LOOP_SWEEP = (1, 2, 4, 8)


def renamed_source(csrc: Path, out: Path) -> tuple[Path, bool]:
    """A copy of csrc/gather_probe.cu in `out` whose namespace gp is
    gp_parent; returns the directory and whether its entry point takes a
    per_thread argument."""
    src = (csrc / "gather_probe.cu").read_text()
    src = src.replace("namespace gp {", "namespace gp_parent {")
    src = src.replace("gp::", "gp_parent::")
    out.mkdir(parents=True, exist_ok=True)
    dst = out / "gather_probe.cu"
    if not dst.exists() or dst.read_text() != src:
        dst.write_text(src)
    return out, "per_thread" in src


def parent_launcher(lib, planned: bool):
    """kind, tab, idx -> out through the parent library's entry point."""
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.cps_gather_probe.argtypes = ([c_int, c_ptr, c_int, c_int, c_ptr,
                                      c_int, c_ptr] + [c_int] * (7 if planned
                                                                 else 6)
                                     + [c_ptr])
    lib.cps_gather_probe.restype = c_int

    def launch(kind, tab, idx):
        (W, C), R = tab.shape, idx.shape[0]
        out = torch.empty((R, C), dtype=tab.dtype, device=tab.device)
        vec4 = C % 4 == 0 and tab.data_ptr() % 16 == 0
        if not planned:
            args = (0,) * 5
        elif kind == "loop":
            args = gp.loop_plan(C, R, vec4, gp._sms(tab.device.index)).args
        else:
            args = gp.onehot_plan(W, C, R, vec4).args
        err = lib.cps_gather_probe(
            gp.KINDS[kind], tab.data_ptr(), W, C, idx.data_ptr(), R,
            out.data_ptr(), *args, int(vec4),
            torch._C._cuda_getCurrentRawStream(tab.device.index))
        if err != 0:
            raise RuntimeError(f"parent gather probe {kind}: cuda error {err}")
        return out
    return launch


def compare(kind, tab, idx, parent, whole_table=False) -> dict:
    """One kernel, parent against this, on one input: agreement, then
    device and call ms in turns."""
    this = gp.PROBES[kind]
    got, old = this(tab, idx), parent(kind, tab, idx)
    ref = gp.PLAIN[kind](tab, idx)
    torch.cuda.synchronize()
    agree = gp.probe_equal(kind, got, old) and gp.probe_equal(kind, got, ref)
    fns = {"parent": lambda: parent(kind, tab, idx),
           "this": lambda: this(tab, idx)}
    dev = {"parent": [], "this": []}
    call = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        dev[name].append(cuda_device_ms(fns[name]))
        call[name].append(cuda_time_ms(fns[name]))
    mean = {k: sum(v) / len(v) for k, v in dev.items()}
    bound = gp.bound_ms(tab, idx, whole_table)
    (W, C), R = tab.shape, idx.shape[0]
    return {"kernel": kind, "W": W, "C": C, "R": R, "agree": agree,
            "parent_ms": mean["parent"], "ms": mean["this"],
            "turns_ms": dev,
            "parent_call_ms": sum(call["parent"]) / 2,
            "call_ms": sum(call["this"]) / 2,
            "bound_ms": bound, "parent_share": bound / mean["parent"],
            "share": bound / mean["this"]}


def sweep_onehot(dev) -> list[dict]:
    """K6 at the probe's shape under each SWEEP plan: agreement with the
    plain version (in-range and non-finite inputs) and device ms."""
    cases = [gp.probe_inputs(dev),
             gp.probe_inputs(dev, out_of_range=True, nonfinite=True)]
    (W, C), R = cases[0][0].shape, cases[0][1].shape[0]
    rows = []
    for cs, nv in SWEEP:
        p = gp.onehot_plan(W, C, R, True, cs, nv)
        agree = True
        for tab, idx in cases:
            got = gp._launch("onehot", tab, idx, p.args)
            agree &= gp.probe_equal("onehot", got, gp.onehot_plain(tab, idx))
        tab, idx = cases[0]
        ms = cuda_device_ms(lambda: gp._launch("onehot", tab, idx, p.args))
        rows.append({"cs": p.cs, "nv": p.slab // p.vw, "slabs": p.slabs,
                     "groups": p.groups, "blocks": p.cs * p.slabs * p.groups,
                     "ms": ms, "agree": agree})
    return rows


def sweep_loop(tab, idx) -> list[dict]:
    """K5 on (tab, idx) at each U of LOOP_SWEEP: agreement with
    index_select, device ms, share of the bound."""
    (W, C), R = tab.shape, idx.shape[0]
    ref, bound = tab.index_select(0, idx), gp.bound_ms(tab, idx)
    rows = []
    for u in LOOP_SWEEP:
        args = (0, 0, 0, -(-R * C // (4 * gp.THREADS * u)), 0, u)
        agree = torch.equal(gp._launch("loop", tab, idx, args), ref)
        ms = cuda_device_ms(lambda: gp._launch("loop", tab, idx, args))
        rows.append({"U": u, "blocks": args[3], "ms": ms,
                     "share": bound / ms, "agree": agree})
    return rows


def library(calls: dict) -> dict:
    """name -> call and device ms of each PyTorch call in `calls`."""
    return {k: {"ms": cuda_time_ms(f), "device_ms": cuda_device_ms(f)}
            for k, f in calls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="time K6 under every launch plan of SWEEP")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_probes: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = BUILD_DIR.parent / "compare_probes"
    src, planned = renamed_source(
        args.parent / "ceedpetscsolid_tpu_torch" / "csrc", out / "src")
    path, _ = build(src, out, UNITS)
    parent = parent_launcher(ctypes.CDLL(str(path)), planned)
    card = card_line()
    print(f"card: {card}; parent {args.parent}")
    tab, idx = gp.probe_inputs(dev)
    rows = [compare("loop", tab, idx, parent),
            compare("onehot", tab, idx, parent, whole_table=True)]
    i, m = idx.long(), gp.onehot_matrix(tab, idx)
    lib = {"probe": library({"tab[idx]": lambda: tab[i],
                             "onehot @ tab": lambda: torch.matmul(m, tab)})}
    W, R, C = gp.PRODUCTION_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    ptab = torch.randn((W, C), generator=g, device=dev)
    pidx = torch.randint(0, W, (R,), generator=g, device=dev,
                         dtype=torch.int32)
    rows.append(compare("loop", ptab, pidx, parent))
    lib["production"] = library(
        {"index_select": lambda: ptab.index_select(0, pidx)})
    print(f"device ms, parent / this (mean of two turns each), call ms, bound "
          f"and share of it ({card}):")
    for r in rows:
        print(f"  gather_{r['kernel']:7s} ({r['W']}, {r['C']}) / ({r['R']},): "
              f"device parent {r['parent_ms']:.4f}  this {r['ms']:.4f} ms; "
              f"call parent {r['parent_call_ms']:.4f}  this "
              f"{r['call_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms, share "
              f"{r['parent_share']:.3f} -> {r['share']:.3f}  "
              f"{'agree' if r['agree'] else 'DIFFER'}")
    for shape, calls in lib.items():
        for k, t in calls.items():
            print(f"  {shape} {k}: call {t['ms']:.4f} ms, device "
                  f"{t['device_ms']:.4f} ms")
    sweep = sweep_onehot(dev) if args.sweep else []
    for r in sweep:
        print(f"  sweep gather_onehot cluster {r['cs']} x {r['nv']} vectors "
              f"a slab, {r['slabs']} slab(s) x {r['groups']} group(s) = "
              f"{r['blocks']} blocks: device {r['ms']:.4f} ms  "
              f"{'agree' if r['agree'] else 'DIFFER'}")
    loops = sweep_loop(ptab, pidx) if args.sweep else []
    for r in loops:
        print(f"  sweep gather_loop production U = {r['U']}, {r['blocks']} "
              f"blocks: device {r['ms']:.4f} ms, share {r['share']:.3f}  "
              f"{'agree' if r['agree'] else 'DIFFER'}")
    sweep += loops
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows,
                                         "library": lib, "sweep": sweep},
                                        indent=1))
    if not all(r["agree"] for r in rows + sweep):
        print("compare_probes: the kernels disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
