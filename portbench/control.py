"""The control of a cell's check, at the cell's own size on the card.

    python3 portbench/control.py --workload <name> --seeds 1,2,3

The control is the plain reference put in the program's place, one
relaxation round short of its answer (a single-source answer after
every round but the last that changed a distance; a point-to-point
answer after every round but the one that settled the target): the
answer of a solver that leaves its loop one step early. Its answers go
through the comparison the runs make (``pbcore.check``); one line of
JSON a seed gives the numbers compared, which the control has to fail,
and the reference's seconds a query. The benchmark's runs never run
this.
"""
import time

if __name__ == "__main__":
    import argparse
    import json
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here)]
    import torch

    from pbcore import check, traffic
    from pbcore.spec import Spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("control: no CUDA device")
    dev = torch.device("cuda", 0)
    spec = Spec()
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    solver = spec.reference(cfg["reference"])
    tree = spec.tree()

    def walk(pred, s, t):
        path, p = [t], pred.cpu().numpy()
        while path[-1] != s and len(path) <= p.shape[0]:
            if p[path[-1]] < 0:
                return None
            path.append(int(p[path[-1]]))
        return path[::-1] if path[-1] == s else None

    for seed in (int(s) for s in args.seeds.split(",")):
        inst = spec.generator(cfg["graph"]["generator"]).make(cfg["graph"],
                                                              seed, dev)
        free = None if inst.free is None else inst.free.cpu().numpy()
        qs = traffic.stream(mix, inst.n, free, seed, traffic.WINDOW)
        samples, rounds, t_ref = [], [], 0.0
        for _ in range(int(cfg["compare_queries"])):
            q = next(qs)
            t0 = time.perf_counter()
            full = solver.solve(inst, q.source, track=True)
            torch.cuda.synchronize(dev)
            t_ref += time.perf_counter() - t0
            if q.kind == "single_source":
                cut = full.rounds - 1
            else:
                cut = int(full.changed_at[q.target]) - 1
            short = solver.solve(inst, q.source, max_rounds=cut).dist
            pred = tree.argmin_pred(inst, short, q.source)
            rounds.append((full.rounds, cut))
            if q.kind == "single_source":
                samples.append((q, short, pred))
            else:
                samples.append((q, int(short[q.target]),
                                walk(pred, q.source, q.target)))
        got = check.compare(mix["query"], solver, tree, inst, samples)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "fails": not check.verdict(got),
                          "rounds": rounds,
                          "reference_s_per_query": t_ref / len(samples)}),
              flush=True)
