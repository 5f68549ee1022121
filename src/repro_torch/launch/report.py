"""Render the §Dry-run/§Roofline tables of dry-run records.

Port copy of :mod:`repro.launch.report` (pure JSON and strings): the
records of both packages' dry runs have the same keys, so
:func:`roofline_table` and :func:`dryrun_table` render either.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def _gib(b):
    return f"{b / 2**30:.2f}"


def load(dir_: Path) -> list[dict]:
    rows = []
    for p in sorted(dir_.glob("*.json")):
        rows.append(json.loads(p.read_text()))
    return rows


def roofline_table(rows: list[dict], mesh: str = "pod16x16") -> str:
    out = ["| arch | shape | flops/chip | bytes/chip | coll B/chip | "
           "t_comp (s) | t_mem (s) | t_coll (s) | bound | useful | frac | "
           "mem GiB |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['flops_per_chip']:.2e} | "
            f"{rf['bytes_per_chip']:.2e} | {rf['coll_bytes_per_chip']:.2e} | "
            f"{rf['t_compute']:.3f} | {rf['t_memory']:.3f} | "
            f"{rf['t_collective']:.3f} | {rf['bottleneck']} | "
            f"{rf['useful_ratio']:.3f} | {r['roofline_fraction']:.4f} | "
            f"{_gib(r['memory_analysis']['temp_bytes'])} |")
    return "\n".join(out)


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | compile s | arg GiB | temp GiB | "
           "collective kinds (B/chip) |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r["roofline"]
        kinds = ", ".join(f"{k}:{v:.2e}"
                          for k, v in sorted(rf["coll_by_kind"].items()))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compile_sec']} | "
            f"{_gib(r['memory_analysis']['argument_bytes'])} | "
            f"{_gib(r['memory_analysis']['temp_bytes'])} | {kinds} |")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--which", default="roofline",
                    choices=["roofline", "dryrun", "both"])
    args = ap.parse_args()
    rows = load(Path(args.dir))
    if args.which in ("roofline", "both"):
        print("### single-pod (16x16) roofline baselines\n")
        print(roofline_table(rows, "pod16x16"))
    if args.which in ("dryrun", "both"):
        print("\n### all dry-run cells\n")
        print(dryrun_table(rows))


if __name__ == "__main__":
    main()
