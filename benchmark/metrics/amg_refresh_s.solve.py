"""The AMG refreshes' seconds a solve (ops/assembly.py element matrices,
the copy to the host, native.py + csrc/amg.cpp setup, solve/amg.py upload:
the four parts of ElasticityProblem.amg_times), the window's mean."""

from benchmark.readers import untraced


def read(run):
    recs = [r for r in untraced(run["records"]) if "amg_s" in r]
    if not recs:
        return None
    return sum(sum(r["amg_s"].values()) for r in recs) / len(recs)
