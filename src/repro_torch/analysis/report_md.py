"""Render dryrun_reports.json into the roofline tables (counterpart of
``repro.analysis.report_md``; the same text for the same reports).

    PYTHONPATH=src python -m repro_torch.analysis.report_md dryrun_reports.json
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def fmt_s(x):
    if x == 0:
        return "0"
    return f"{x:.2e}"


def table(reports, mesh):
    rows = [r for r in reports if r["mesh"] == mesh]
    out = [
        "| arch | shape | C (s) | M (s) | X (s) | bound | HBM GiB | fits "
        "| useful | roofline |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'][:4]} | {fmt_bytes(r['hbm_bytes_per_dev'])} | "
            f"{'✓' if r['fits_hbm'] else '✗'} | "
            f"{r['useful_ratio']:.1%} | {r['peak_fraction']:.1%} |")
    return "\n".join(out)


def collectives_summary(reports):
    out = ["| arch | shape | mesh | AR | AG | RS | A2A | CP | wire GiB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in reports:
        by = r["collectives"]["by_op"]

        def cnt(op):
            return by.get(op, {}).get("count", 0)

        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{cnt('all-reduce')} | {cnt('all-gather')} | "
            f"{cnt('reduce-scatter')} | {cnt('all-to-all')} | "
            f"{cnt('collective-permute')} | "
            f"{fmt_bytes(r['collectives']['total']['wire_bytes'])} |")
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_reports.json"
    with open(path) as f:
        reports = json.load(f)
    print("### Single-pod 16×16 (256 chips)\n")
    print(table(reports, "16x16"))
    print("\n### Multi-pod 2×16×16 (512 chips)\n")
    print(table(reports, "2x16x16"))
    print("\n### Collective op counts (per compiled step, per device)\n")
    print(collectives_summary([r for r in reports if r["mesh"] == "2x16x16"]))


if __name__ == "__main__":
    main()
